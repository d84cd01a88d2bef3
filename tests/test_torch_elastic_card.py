"""Elastic serving's state transfer on the card (``cuda`` marker; skips
without one).  No JAX here: the card's machine has none.

    python -m pytest -q -m cuda tests/test_torch_elastic_card.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import serve as dserve  # noqa: E402

pytestmark = pytest.mark.cuda


def test_broadcast_peak_on_the_card_stays_within_its_bound():
    """llama3.2-1b's largest leaf (the 128,256 x 2,048 bf16 embedding) and
    a layer stack's leaf at p 5: the joiner's copy equals the source, and
    the peak allocated while it moves stays at most the resident bytes + 5
    x the largest leaf + 1 GiB (the stacked copy of one leaf at a time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"embed": torch.randn(128256, 2048, generator=gen, device="cuda").bfloat16(),
            "w1": torch.randn(16, 2048, 8192, generator=gen, device="cuda").bfloat16(),
            "lengths": np.arange(8, dtype=np.int32)}
    keep = {k: v.clone() if isinstance(v, torch.Tensor) else v.copy() for k, v in tree.items()}
    largest = max(t.numel() * t.element_size() for t in tree.values()
                  if isinstance(t, torch.Tensor))
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = dserve.mrd_broadcast_stacked(tree, 5, src=0)
    torch.cuda.synchronize()
    for k, v in keep.items():
        assert (torch.equal(out[k], v) if isinstance(v, torch.Tensor)
                else np.array_equal(out[k], v)), k
        if isinstance(v, torch.Tensor):
            assert out[k].data_ptr() == tree[k].data_ptr(), k  # in place: no copy of the leaf
    peak = torch.cuda.max_memory_allocated()
    assert peak <= resident + 5 * largest + 2**30, (peak - resident) / largest
