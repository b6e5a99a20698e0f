"""One train step of the MoE families at their smoke configs
(deepseek-v3: MLA + MoE with its dense head layers; llama4-scout: GQA +
MoE), the port's against the reference's: the cases and bounds of
`test_torch_train_archs_dense.py`.  In bfloat16 a router may pick other
experts than the reference's (§3z), which ``BF16_GRAD_DRIFT`` allows for:
the reference's own bfloat16 gradients are 0.18-0.64 from its float32
ones here."""

import pytest

from test_torch_train_archs_dense import Results, check_bfloat16, check_float32
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MOE = ["deepseek-v3-671b", "llama4-scout-17b-a16e"]


@pytest.fixture(scope="module")
def ref():
    return Results()


@pytest.mark.parametrize("arch", MOE)
def test_float32_train_step_matches_the_reference(ref, arch):
    check_float32(ref, arch)


@pytest.mark.parametrize("arch", MOE)
def test_bfloat16_train_step_within_the_references_own_drift(ref, arch):
    check_bfloat16(ref, arch)
