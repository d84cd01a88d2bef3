"""The port's train steps against the reference's for the families of the
plain stack with a part of their own: the moe experts (mixtral-8x7b,
llama4-scout: capacity drops and the aux loss), the vlm backbone with its
patches (internvl2-1b) and the bidirectional audio encoder with its frames
and gelu MLP (hubert-xlarge), at their smoke configs, dp 3, under
``mrd_zero1`` and ``compressed`` for 3 steps.  The recording, the
teacher-forced steps and the tolerances are
``test_torch_train_families.py``'s.
"""

import pytest

pytest.importorskip("torch")

from test_torch_train_families import LR, MODES, STEPS, DP, check_train_steps  # noqa: E402
from torch_train_ref import one_thread, record_script, run_reference  # noqa: E402,F401

ARCHS = ("mixtral-8x7b", "llama4-scout-17b-a16e", "internvl2-1b", "hubert-xlarge")


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    script = record_script({a: list(MODES) for a in ARCHS}, steps=STEPS, lr=LR, modes=MODES)
    return run_reference(script, tmp_path_factory.mktemp("ref") / "ref.npz", devices=DP)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(reference_run, arch, mode):
    check_train_steps(reference_run, arch, mode)
