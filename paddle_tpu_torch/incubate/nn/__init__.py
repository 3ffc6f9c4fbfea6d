from .fused_transformer import (FusedMultiTransformer,  # noqa: F401
                                FusedMultiTransformerInt8)

__all__ = ["FusedMultiTransformer", "FusedMultiTransformerInt8"]
