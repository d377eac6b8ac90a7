"""``RunCtx``'s other knobs on one device, with
``tests/test_torch_runctx.py``'s ``_check`` (the port's loss and every
gradient leaf against ``jax.value_and_grad`` of the reference's
``loss_fn(ctx=RunCtx(...))``, loss rtol 1e-5, each leaf 1e-4 of its
largest |g|):

* each ``moe_method`` (sort through B5's plain version, cumsum, einsum)
  on arctic-480b and deepseek-v2-236b;
* a ``q_chunk`` that splits S (the plain attention's query chunks, the
  backward's recompute over them, MLA's checkpointed chunks), with and
  without remat.
"""

import pytest

from test_torch_runctx import _check


@pytest.mark.parametrize("method", ["sort", "cumsum", "einsum"])
@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v2-236b"])
def test_moe_method_loss_and_gradients_match_reference(arch, method):
    _check(arch, moe_method=method)


@pytest.mark.parametrize("remat", ["none", "block"])
@pytest.mark.parametrize("arch", ["xlb-service-model", "deepseek-v2-236b",
                                  "whisper-large-v3"])
def test_q_chunk_loss_and_gradients_match_reference(arch, remat):
    """8-row query chunks of the 32-token sequences (whisper's encoder:
    of its frames too, where 8 divides them)."""
    _check(arch, q_chunk=8, remat=remat)
