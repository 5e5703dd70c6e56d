"""The port's KGE losses (adapm_tpu_torch/models/kge.py) against the JAX
package's: the loss and its gradient with respect to every role's rows,
for ComplEx and RESCAL, with and without self-adversarial weighting and
L2, on the same numpy inputs. Tolerance rtol 1e-5: float32 model math
whose sums XLA and PyTorch may order differently."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from adapm_tpu.models.kge import make_kge_loss as jax_loss
from adapm_tpu_torch.models.kge import make_kge_loss as torch_loss

B, N, D = 6, 5, 4
ROLES = ("s", "r", "o", "neg")


def _embs(model, seed):
    rng = np.random.default_rng(seed)
    ent = 2 * D if model == "complex" else D
    rel = 2 * D if model == "complex" else D * D
    return {"s": rng.normal(size=(B, ent)), "o": rng.normal(size=(B, ent)),
            "r": rng.normal(size=(B, rel)),
            "neg": rng.normal(size=(B, N, ent))}


@pytest.mark.parametrize("model", ["complex", "rescal"])
@pytest.mark.parametrize("self_adv,l2", [(0.0, 0.0), (1.0, 0.0),
                                         (0.0, 0.01), (0.5, 0.02)])
def test_loss_and_grads_match_jax(model, self_adv, l2):
    embs = {k: v.astype(np.float32) for k, v in _embs(model, 7).items()}
    f_j = jax_loss(model, self_adv_temp=self_adv, l2=l2)
    loss_j, g_j = jax.value_and_grad(lambda e: f_j(e, None))(
        {k: jnp.asarray(v) for k, v in embs.items()})
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in embs.items()}
    loss_t = torch_loss(model, self_adv_temp=self_adv, l2=l2)(leaves, None)
    grads = torch.autograd.grad(loss_t, [leaves[k] for k in ROLES])
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for k, g in zip(ROLES, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_scores_match_jax_on_large_margins():
    # softplus far out in both tails (|score| > 20): logaddexp form
    from adapm_tpu.models.kge import _nll_loss as jnll
    from adapm_tpu_torch.models.kge import _nll_loss as tnll
    pos = np.array([-40.0, -5.0, 0.0, 30.0], np.float32)
    neg = np.array([[25.0, -25.0], [0.5, 3.0], [-60.0, 60.0], [1.0, 2.0]],
                   np.float32)
    ref = float(jnll(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(neg),
                     2.0))
    got = tnll(torch.from_numpy(pos), torch.from_numpy(neg),
               torch.from_numpy(neg), 2.0).item()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
