"""Model families as PyTorch loss functions pluggable into ops/fused.py."""
from .kge import complex_score, make_kge_loss, rescal_score  # noqa: F401
