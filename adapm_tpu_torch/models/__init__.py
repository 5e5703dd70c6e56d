"""Model families as PyTorch loss functions pluggable into ops/fused.py."""
from .kge import complex_score, make_kge_loss, rescal_score  # noqa: F401
from .mf import col_key, full_loss, make_mf_loss, row_key  # noqa: F401
from .sgns import (build_unigram_table, sgns_loss, syn0_key,  # noqa: F401
                   syn1_key)
