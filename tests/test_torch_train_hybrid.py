"""PyTorch port vs JAX reference: training the hybrid family
(zamba2-7b), with the checks and tolerances of
``tests/test_torch_train_ssm.py`` (its own file, so ``--dist loadfile``
runs it beside the SSM one): ``lm_loss`` and every gradient leaf, the
shared block's included, on ``exact`` under remat and ``moment`` (grid
off); 3 AdamW steps on ``exact`` and ``moment``; kernel 5's calls a
step.
"""

import pytest

from test_torch_train_ssm import (  # noqa: F401  (the autouse fixture)
    _one_torch_thread,
    check_kernel5_calls,
    check_loss_and_gradients,
    check_train_steps,
)


@pytest.mark.parametrize("arch,backend,kw,grid", [
    ("zamba2-7b", "exact", dict(remat="full"), True),
    ("zamba2-7b", "moment", {}, False),
])
def test_lm_loss_and_gradients_match_reference(arch, backend, kw, grid,
                                               monkeypatch):
    check_loss_and_gradients(arch, backend, kw, grid, monkeypatch)


@pytest.mark.parametrize(
    "arch,backend,grid",
    [("zamba2-7b", "exact", True), ("zamba2-7b", "moment", False)],
)
def test_train_steps_match_reference(arch, backend, grid, monkeypatch):
    check_train_steps(arch, backend, grid, monkeypatch)


@pytest.mark.parametrize("arch", ["zamba2-7b"])
def test_kernel5_calls_a_step_do_not_depend_on_batch_or_seq(arch,
                                                            monkeypatch):
    check_kernel5_calls(arch, monkeypatch)
