"""Fleet meta-optimizers (counterpart of paddle_tpu/distributed/fleet/
meta_optimizers/__init__.py): LARS and DGC replace a ``Momentum`` rule,
gradient merge and local SGD wrap the schedule; ``apply_meta_optimizers``
composes them from the strategy's flags in the reference's order."""
from .dgc import DGCMomentum, DGCOptimizer
from .gradient_merge import GradientMergeOptimizer
from .lars import LarsMomentum, LarsOptimizer
from .localsgd import LocalSGDOptimizer

__all__ = ["GradientMergeOptimizer", "LarsMomentum", "LarsOptimizer",
           "DGCMomentum", "DGCOptimizer", "LocalSGDOptimizer"]


def apply_meta_optimizers(optimizer, strategy):
    """``optimizer`` rewritten by ``strategy``'s flags: lars, then dgc
    (each replaces a Momentum rule), then gradient_merge and localsgd
    (each wraps the schedule)."""
    if strategy is None:
        return optimizer
    if getattr(strategy, "lars", False):
        optimizer = LarsOptimizer(optimizer, strategy).target_optimizer()
    if getattr(strategy, "dgc", False):
        optimizer = DGCOptimizer(optimizer, strategy).target_optimizer()
    if getattr(strategy, "gradient_merge", False):
        cfg = strategy.gradient_merge_configs
        optimizer = GradientMergeOptimizer(
            optimizer, k_steps=cfg.get("k_steps", 1),
            avg=cfg.get("avg", True))
    if getattr(strategy, "localsgd", False):
        cfg = getattr(strategy, "localsgd_configs", {})
        optimizer = LocalSGDOptimizer(
            optimizer, k_steps=cfg.get("k_steps", 1) if cfg else 1)
    return optimizer
