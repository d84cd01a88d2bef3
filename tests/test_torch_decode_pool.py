"""The port's contiguous ``llm_decode`` serving against the reference's.

The reference ``ServeEngine`` serves four requests on ``llm_decode``
(fp32 smoke configs: llama3.2-1b, gemma3-12b with its 16-token local
window, and falcon-mamba-7b with its recurrent state) at dp 1 and dp 3, with 3 slots so a slot is recycled, staggered
arrivals, prompts of 6-24 tokens and budgets that carry every gemma3
request past the window.  The port's engine serves the same requests on
the CPU from the converted weights: every request's output token ids and
its admission and retirement ticks must be identical.

Also here: ``llm_decode`` and ``llm_decode_paged`` give the same tokens
(contiguous and block-paged caches are the same cache).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import registry as ref_registry  # noqa: E402
from repro.serving import Request as RefRequest  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import ServeEngine as RefServeEngine  # noqa: E402
from repro.serving import make_workload as ref_make_workload  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.serving import DecodePool, Request, ServeConfig, ServeEngine, make_workload  # noqa: E402,E501

SLOTS, MAX_PROMPT, MAX_LEN = 3, 24, 48
ARRIVALS = [0, 0, 1, 3]
PLENS = [6, 24, 13, 9]
MAX_NEW = [18, 7, 20, 12]


def _requests(cfg, cls):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in PLENS]
    return [cls(id=i, arrival=ARRIVALS[i], prompt=prompts[i], max_new=MAX_NEW[i])
            for i in range(len(PLENS))]


@functools.lru_cache(maxsize=None)
def _reference(arch, dp):
    """The reference's run: results and its weights as numpy arrays."""
    rcfg = ref_registry.get_smoke_config(arch)
    mesh = compat.make_mesh((1,), ("data",), devices=jax.devices()[:1],
                            axis_types=compat.default_axis_types(1))
    wl = ref_make_workload("llm_decode", cfg=rcfg, mesh=mesh, slots=SLOTS, max_len=MAX_LEN,
                           max_prompt_len=MAX_PROMPT, seed=0)
    res = RefServeEngine(wl, RefServeConfig(dp=dp)).run(_requests(rcfg, RefRequest))
    return res, jax.tree.map(np.asarray, wl.params)


def _port(arch, dp, workload="llm_decode", **kw):
    cfg = registry.get_smoke_config(arch)
    _, np_params = _reference(arch, 1)
    wl = make_workload(workload, cfg=cfg, slots=SLOTS, max_len=MAX_LEN,
                       max_prompt_len=MAX_PROMPT, device="cpu",
                       params=params_from_reference(np_params, cfg, device="cpu"), **kw)
    eng = ServeEngine(wl, ServeConfig(dp=dp))
    return wl, eng, eng.run(_requests(cfg, Request))


@pytest.mark.parametrize("dp", [1, 3])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-12b", "falcon-mamba-7b"])
def test_tokens_and_ticks_match_reference_engine(arch, dp):
    ref_res, _ = _reference(arch, dp)
    wl, eng, res = _port(arch, dp)
    assert isinstance(wl.pool, DecodePool)
    assert sorted(res) == sorted(ref_res)
    for i, r in ref_res.items():
        np.testing.assert_array_equal(res[i].output, r.output)
        assert (res[i].admit_tick, res[i].retire_tick) == (r.admit_tick, r.retire_tick)
        assert res[i].n_tokens == r.n_tokens and res[i].converged == r.converged
    s = eng.summary()
    assert s["completed"] == len(ref_res) and s["forced_at_capacity"] == 0
    assert wl.prefills == len(ref_res)
    if arch == "gemma3-12b":  # every request decoded past the local window
        window = registry.get_smoke_config(arch).local_window
        assert all(PLENS[i] + r.n_tokens > window for i, r in res.items())


def test_contiguous_and_paged_pools_give_the_same_tokens():
    _, _, contiguous = _port("llama3.2-1b", 3)
    _, _, paged = _port("llama3.2-1b", 3, workload="llm_decode_paged", block_size=8)
    for i, r in contiguous.items():
        np.testing.assert_array_equal(r.output, paged[i].output)
        assert (r.admit_tick, r.retire_tick) == (paged[i].admit_tick, paged[i].retire_tick)


def test_pool_freezes_at_capacity_and_resets():
    """A slot at max_len - 1 stops advancing (the engine force-retires it);
    reset gives a zero cache with the same weights."""
    cfg = registry.get_smoke_config("gemma3-12b")
    pool = DecodePool(cfg, slots=2, max_len=12, max_prompt_len=10, device="cpu")
    params = make_workload("llm_decode", cfg=cfg, slots=1, max_len=12, max_prompt_len=10,
                           device="cpu").params
    pool.admit(params, np.arange(10), 0)
    for _ in range(3):
        pool.step(params, np.array([True, False]))
    assert pool.lengths.tolist() == [11, 0]
    assert pool.capacity_mask().tolist() == [True, False]
    assert pool.cache_bytes == sum(t.numel() * 4 for t in pool.cache.values())
    pool.reset()
    assert pool.lengths.tolist() == [0, 0]
    assert all(not t.any() for t in pool.cache.values())
