"""Parity of avr_torch's fused renderer with the JAX one across variants
and plans (CPU, fp32): the standard variant with channel embeddings (add
and concat) and the complex variant, each over the precomputed and the
streaming plan (``point_budget=0``) and shell chunks of 1 and 4. Forward
within 5e-5 of scale, the gradient of every leaf within 1e-4 of scale
(tests/test_render.py's tolerances). Ray directions are passed to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avr_tpu.render import common as jcommon
from avr_tpu.render import fused as jfused
from test_torch_field import complex_setup
from test_torch_field_standard import check_vjp, standard_setup
from test_torch_render import _scene

from avr_torch.render import common as tcommon
from avr_torch.render import fused as tfused

torch.set_num_threads(2)

VARIANTS = ["standard_add", "standard_concat", "complex"]


def variant_setup(variant):
    """(JAX params, JAX static, port params, port static, ch_idx or None)."""
    if variant == "complex":
        return (*complex_setup("hybridc:2"), None)
    return (*standard_setup(variant.split("_")[1]), np.asarray([3, 6], np.int32))


@pytest.mark.parametrize("shell_chunk", [1, 4])
@pytest.mark.parametrize("point_budget", [4_000_000, 0], ids=["precomputed", "streaming"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_render_fused_matches_jax(variant, point_budget, shell_chunk):
    jparams, jfst, tparams, tfst, ch = variant_setup(variant)
    rc, rays_o, tx, tx_view, dirs, _ = _scene()
    if variant != "complex":
        tx_view = None
    kw = dict(compute_dtype=None, shell_chunk=shell_chunk, point_budget=point_budget)
    jc, tc = jcommon.make_consts(rc, 64), tcommon.make_consts(rc, 64, device="cpu")
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    check_vjp(
        lambda p: (jfused.render_fused(p, jfst, jc, rc, j(rays_o), j(tx), direction_tx=j(tx_view),
                                       ch_idx=j(ch), dirs=j(dirs), **kw),),
        lambda p: (tfused.render_fused(p, tfst, tc, rc, t(rays_o), t(tx), direction_tx=t(tx_view),
                                       ch_idx=t(ch), dirs=t(dirs), **kw),),
        jparams, tparams,
    )
