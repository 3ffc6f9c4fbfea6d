"""The PyTorch port's LlamaSpmdTrainer (paddle_tpu_torch/models/
llama_spmd.py) held against the JAX package's on the CPU, from the same
weights (``weights.llama_spmd_trainer`` copies the JAX parameter tree):
logits, the loss, every leaf's gradient, then three ``train_step``s (the
loss sequence, the parameters, and the m / v / master state), then a
fourth step from a port trainer resumed from the JAX trainer's state.
float32 compute; single-device mesh.

Configurations: the jnp path (``_fused`` off against JAX
``_pallas_fused=False``) with GQA; the kernel path (``_fused`` forced on:
the kernels' plain versions) against JAX ``_pallas_fused=True`` (its
Pallas RMSNorm and AdamW in interpret mode) with remat; head_dim 64 at
T = 128, where the port takes the flash branch (JAX takes its dense
branch off the TPU); T = 512, where the cross entropy is chunked
(C = 256) and checkpointed; bf16 moments, which take the plain update
even with ``_fused`` on.

Tolerances: logits 1e-5 and gradients 2e-5 absolute (summation order;
the runs read <= 1e-6); the loss sequence 1e-5 relative; m 1e-6
absolute, v 1e-8 (bf16 moments: 2**-7 relative plus 2**-8 x max|m|,
one bf16 ulp of the step's terms, which nearly cancel in a few entries).
Parameters and masters within 1e-6 + 2 lr min(1, 3e-6 / sqrt(v))
absolute, v the JAX trainer's second moment: AdamW divides the gradient
by sqrt(v), so a gradient difference d (<= ~1e-6 here) moves each
step's update by ~lr d / sqrt(v), and by up to ~lr where sqrt(v) is
near d (the runs read at most a quarter of this bound). bf16 moments add
3 x 2**-7 lr: one bf16 rounding of m or v that falls the other way moves
a step's update by up to one ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama_spmd import LlamaSpmdTrainer as JaxTrainer
from paddle_tpu.parallel import mesh as mesh_mod
from paddle_tpu_torch import weights
from paddle_tpu_torch.models import LlamaConfig, LlamaSpmdTrainer
from paddle_tpu_torch.models.llama_spmd import tree_get, tree_paths
from tests.torch_twins import shared_jax_cache  # noqa: F401

torch.set_num_threads(1)
LR = 1e-3

CONFIGS = {
    # name: (tiny() widths, trainer options, fused)
    "jnp_path_gqa": (dict(hidden=64, heads=4, kv_heads=2, inter=128,
                          vocab=64, seq=16), dict(remat=False), False),
    "kernel_path_remat": (dict(hidden=64, heads=4, kv_heads=2, inter=128,
                               vocab=64, seq=16), dict(remat=True), True),
    "flash_branch_hd64_T128": (dict(hidden=128, heads=2, kv_heads=1,
                                    inter=128, vocab=64, seq=128),
                               dict(remat=False), True),
    "chunked_ce_T512": (dict(hidden=32, heads=2, kv_heads=2, inter=64,
                             vocab=64, seq=512),
                        dict(remat=True, ce_remat=True), False),
    "bf16_moments": (dict(hidden=64, heads=4, kv_heads=2, inter=128,
                          vocab=64, seq=16),
                     dict(remat=False, moments_dtype="bfloat16"), True),
}


def _pair(name):
    widths, opts, fused = CONFIGS[name]
    mesh_mod.build_mesh(dp=1, devices=jax.devices()[:1])
    mdt = opts.get("moments_dtype", "float32")
    jopts = dict(opts, moments_dtype=getattr(jnp, mdt))
    topts = dict(opts, moments_dtype=getattr(torch, mdt))
    jtr = JaxTrainer(JaxLlamaConfig.tiny(layers=2, **widths), lr=LR,
                     compute_dtype=jnp.float32, seed=1, **jopts)
    jtr._pallas_fused = fused

    def port(**state):
        """A port trainer holding the JAX trainer's current state."""
        tr = weights.llama_spmd_trainer(
            jax.tree_util.tree_map(np.asarray, jtr.params),
            LlamaConfig.tiny(layers=2, **widths), device="cpu", lr=LR,
            compute_dtype=torch.float32, **topts, **state)
        tr._fused = fused
        return tr

    ids = np.random.RandomState(0).randint(0, widths["vocab"],
                                           (2, widths["seq"]))
    return jtr, port, ids


class _Analytics:
    """What flops_per_token reads, without building the parameters."""

    def __init__(self, config):
        self.config = config
        self.head_dim = config.hidden_size // config.num_attention_heads


def _f32(a):
    return np.asarray(a, np.float32)


def _jax_reference(jtr, jids):
    """The JAX trainer's logits, loss and gradients at its parameters,
    built once as one compiled program (op by op, each primitive of the
    forward and its gradient compiled on its own)."""
    return jax.jit(lambda p, i: (jtr.forward(p, i), jax.value_and_grad(
        jtr.loss_fn)(p, i, i)))(jtr.params, jids)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_trainer_matches_jax_trainer(name):
    jtr, port, ids = _pair(name)
    ptr = port()
    jids = jnp.asarray(ids)
    jlogits, (jloss, jgrads) = _jax_reference(jtr, jids)
    with torch.no_grad():
        logits = ptr.forward(ptr.params, ids)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-5, rtol=0)
    loss = ptr.loss_fn(ptr.params, ids, ids)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    paths = tree_paths(ptr.params)
    assert paths == [tuple(k.key for k in p) for p, _ in
                     jax.tree_util.tree_flatten_with_path(jtr.params)[0]]
    grads = torch.autograd.grad(loss, [tree_get(ptr.params, p)
                                       for p in paths])
    for path, g in zip(paths, grads):
        np.testing.assert_allclose(g.numpy(), _f32(tree_get(jgrads, path)),
                                   atol=2e-5, rtol=0, err_msg=str(path))
    jl = [float(jtr.train_step(ids)) for _ in range(3)]
    pl = [float(ptr.train_step(ids)) for _ in range(3)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    bf16 = ptr.moments_dtype == torch.bfloat16
    for path in paths:
        st, jst = tree_get(ptr.opt_state, path), tree_get(jtr.opt_state,
                                                          path)
        root_v = np.sqrt(_f32(jst["v"]))
        bound = (1e-6 + (3 * 2 ** -7 * LR if bf16 else 0.0)
                 + 2 * LR * np.minimum(1.0, 3e-6 / np.maximum(root_v, 1e-30)))
        for what, got, want in (
                ("param", tree_get(ptr.params, path).detach().numpy(),
                 _f32(tree_get(jtr.params, path))),
                ("master", st["master"].numpy(), _f32(jst["master"]))):
            err = np.abs(got - want)
            assert (err <= bound).all(), (
                f"{path} {what}: {err.max()} at worst, "
                f"{(err / bound).max()} x its bound")
        for k, atol in (("m", 1e-6), ("v", 1e-8)):
            want = _f32(jst[k])
            if bf16:
                # one bf16 ulp of the step's terms: where b1 m and
                # (1 - b1) g nearly cancel, that is a large part of m
                atol = 2 ** -8 * float(np.abs(want).max())
            np.testing.assert_allclose(
                st[k].float().numpy(), want, atol=atol,
                rtol=2 ** -7 if bf16 else 0, err_msg=f"{path} {k}")
    # a port trainer resumed from the JAX trainer's parameters, optimizer
    # state and step count takes the same fourth step (its first moment
    # is b1 m + (1 - b1) g: only equal when m was carried over)
    resumed = port(opt_state_np=jax.tree_util.tree_map(np.asarray,
                                                       jtr.opt_state),
                   step=3)
    np.testing.assert_allclose(float(resumed.train_step(ids)),
                               float(jtr.train_step(ids)), rtol=1e-5)
    for path in paths:
        want = _f32(tree_get(jtr.opt_state, path)["m"])
        np.testing.assert_allclose(
            tree_get(resumed.opt_state, path)["m"].float().numpy(), want,
            atol=2 ** -8 * float(np.abs(want).max()) if bf16 else 1e-6,
            rtol=2 ** -7 if bf16 else 0, err_msg=f"{path} m, resumed")


def test_single_device_only():
    """The mesh options that raised while the port trained on one device
    only are accepted on a one-rank mesh (pp 1: the interleave and the
    stage checkpoint take no effect, as in the reference); a bad
    remat_policy still raises, and from_state_dict sits in the
    reference's 11th position."""
    cfg = LlamaConfig.tiny()
    for kw in (dict(n_virtual=2), dict(remat_stage=True),
               dict(remat_policy="save_dots"),
               dict(remat_policy="save_attn")):
        tr = LlamaSpmdTrainer(cfg, device="cpu", **kw)
        for k, v in kw.items():
            assert getattr(tr, k) == v
    with pytest.raises(ValueError, match="remat_policy"):
        LlamaSpmdTrainer(cfg, device="cpu", remat_policy="some")
    tr = LlamaSpmdTrainer(cfg, 3e-4, 0.1, 0.9, 0.95, 1e-8, True, None, 0,
                          torch.float32, {"ignored": 1}, "save_attn",
                          device="cpu")
    assert tr.remat_policy == "save_attn"


def test_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaSpmdTrainer(LlamaConfig.tiny())
    tr = LlamaSpmdTrainer(LlamaConfig.tiny(), device="cpu")
    assert not tr._fused


def test_analytics_match_jax_trainer():
    mesh_mod.build_mesh(dp=1, devices=jax.devices()[:1])
    kw = dict(vocab=96, hidden=64, layers=3, heads=4, kv_heads=2, inter=96,
              seq=32)
    jtr = JaxTrainer(JaxLlamaConfig.tiny(**kw), compute_dtype=jnp.float32)
    ptr = LlamaSpmdTrainer(LlamaConfig.tiny(**kw), device="cpu",
                           compute_dtype=torch.float32)
    assert ptr.param_count() == jtr.param_count()
    for T in (None, 16):
        assert ptr.flops_per_token(T) == jtr.flops_per_token(T)
    # bench.py's Llama-2-7B proxy: 3.316e9 FLOP per token at T = 2048
    big = LlamaConfig(vocab_size=32000, hidden_size=4096,
                      intermediate_size=11008, num_hidden_layers=2,
                      max_position_embeddings=2048)
    assert LlamaSpmdTrainer.flops_per_token(
        _Analytics(big), 2048) == 3315597312
