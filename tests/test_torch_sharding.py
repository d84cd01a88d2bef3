"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's, with no process group: the rules are built from the
mesh's axis names and sizes on both sides (the reference's through a
stand-in mesh, as ``tests/test_data_and_sharding.py`` builds one).

- ``param_specs`` of every registry arch, full and smoke shapes, over the
  ``(dp, tp)`` grid, equal the reference's spec for spec (as tuples; the
  port's leaves nested as the reference nests them);
- ``spec_for`` of every kind, ``kv_repeat_factor`` over a grid of
  ``(H, KV, tp)``, ``manual_region``/``full_manual_region``;
- ``local_shard`` and ``local_index``.

The full-width shapes come from ``jax.eval_shape`` and the port's
``transformer.param_shapes`` (fake tensors): no weight is made.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import convert, transformer  # noqa: E402

MESHES = [(1, 1), (2, 1), (3, 1), (4, 1), (1, 2), (2, 2), (1, 4), (4, 2)]
ARCHS = registry.list_archs()


class FakeMesh:
    """What the reference's rules read of a mesh: its axis names and sizes."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


def sizes(dp: int, tp: int) -> dict:
    return {"data": dp, "model": tp} if tp > 1 else {"data": dp}


@functools.lru_cache(maxsize=None)
def shapes(arch: str, smoke: bool):
    """(the reference's abstract params, the port's fake params)."""
    rcfg = ref_registry.get_smoke_config(arch) if smoke else ref_registry.get_config(arch)
    cfg = registry.get_smoke_config(arch) if smoke else registry.get_config(arch)
    ref = jax.eval_shape(lambda: ref_tf.init_params(rcfg, jax.random.PRNGKey(0)))
    return rcfg, cfg, ref, transformer.param_shapes(cfg)


def ref_spec_leaves(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s) for path, s in flat}


def port_spec_leaves(specs) -> dict:
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out["/".join(path + (k,))] = v

    walk(convert.reference_tree(specs), ())
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=[f"dp{d}-tp{t}" for d, t in MESHES])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_references(arch, smoke, mesh):
    rcfg, cfg, ref_params, params = shapes(arch, smoke)
    mesh_sizes = sizes(*mesh)
    ref_rules = ref_shd.make_rules(rcfg, FakeMesh(mesh_sizes))
    rules = shd.make_rules(cfg, mesh_sizes)
    for f in ("dp_axes", "fsdp_axis", "tp_axis", "attn_heads_sharded", "kv_heads_sharded", "ep"):
        assert getattr(rules, f) == getattr(ref_rules, f), f
    assert (rules.tp, rules.dp) == (ref_rules.tp, ref_rules.dp)
    ref = ref_spec_leaves(ref_shd.param_specs(rcfg, ref_rules, ref_params))
    ours = port_spec_leaves(shd.param_specs(cfg, rules, params))
    assert ours == ref


def test_make_rules_takes_a_mapping_or_a_device_mesh_like():
    cfg = registry.get_smoke_config("mixtral-8x7b")

    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (2, 2)[i]

    assert shd.make_rules(cfg, Mesh()) == shd.make_rules(cfg, {"data": 2, "model": 2})
    r = shd.make_rules(cfg, {"data": 2, "model": 2}, fsdp=False)
    assert r.fsdp_axis is None and not r.ep


KINDS = {
    "tokens": (8, 16, 64), "mb_batch": (2, 4, 16), "q": (4, 16, 8, 16), "k": (4, 16, 4, 16),
    "v": (4, 16, 6, 16), "cache_k": (4, 32, 4, 16), "cache_v": (3, 32, 2, 16),
    "ffn": (4, 16, 128), "expert_buf": (4, 8, 3, 64), "expert_buf_ep": (4, 8, 3, 64),
    "ssm_inner": (4, 16, 128), "logits": (4, 16, 256), "unknown": (4, 4),
}


@pytest.mark.parametrize("mesh", MESHES, ids=[f"dp{d}-tp{t}" for d, t in MESHES])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-32b", "mixtral-8x7b", "zamba2-2.7b"])
def test_spec_for_every_kind(arch, mesh):
    rcfg, cfg = ref_registry.get_smoke_config(arch), registry.get_smoke_config(arch)
    mesh_sizes = sizes(*mesh)
    ref_ctx = ref_shd.ShardingContext(rcfg, ref_shd.make_rules(rcfg, FakeMesh(mesh_sizes)))
    ctx = shd.ShardingContext(cfg, shd.make_rules(cfg, mesh_sizes))
    for kind, shape in KINDS.items():
        for s in (shape, (1,) + shape[1:], (3,) + shape[1:]):
            want = ref_ctx.spec_for(kind, np.zeros(s, np.float32))
            got = ctx.spec_for(kind, torch.empty(s, device="meta"))
            assert got == (None if want is None else tuple(want)), (kind, s)
    ssm = torch.empty((4, 128), device="meta")
    assert ctx.spec_for("ssm_inner", ssm) == tuple(
        ref_ctx.spec_for("ssm_inner", np.zeros((4, 128))))


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_kv_repeat_factor_grid(tp):
    cfg, rcfg = registry.get_smoke_config("llama3.2-1b"), ref_registry.get_smoke_config(
        "llama3.2-1b")
    mesh_sizes = sizes(1, tp)
    assert shd.kv_repeat_factor(8, 2) == 1  # no active context
    with ref_shd.sharding_ctx(rcfg, ref_shd.make_rules(rcfg, FakeMesh(mesh_sizes))), \
            shd.sharding_ctx(cfg, shd.make_rules(cfg, mesh_sizes)):
        for H in (4, 5, 6, 8, 12, 16, 32, 40):
            for KV in (1, 2, 3, 4, 8, 16):
                if H % KV:
                    continue
                assert shd.kv_repeat_factor(H, KV) == ref_shd.kv_repeat_factor(H, KV), (H, KV)


def test_manual_regions():
    cfg, rcfg = registry.get_smoke_config("llama3.2-1b"), ref_registry.get_smoke_config(
        "llama3.2-1b")
    r = shd.make_rules(cfg, {"data": 4, "model": 2})
    rr = ref_shd.make_rules(rcfg, FakeMesh({"data": 4, "model": 2}))
    for a, b in ((r.manual_region(), rr.manual_region()),
                 (r.full_manual_region(), rr.full_manual_region())):
        assert (a.dp_axes, a.fsdp_axis, a.tp_axis) == (b.dp_axes, b.fsdp_axis, b.tp_axis)
        assert a.batch_axes(8) == b.batch_axes(8) is None
    assert r.manual_region().tp_axis == "model" and r.full_manual_region().tp_axis is None
    assert r.batch_axes(8) == ("data",) and r.batch_axes(6) is None


def test_local_shards_tile_the_global_leaf_and_placements_name_them():
    """The blocks tile the leaf, and ``local_index`` names each block's
    slices (what a checkpoint's restore reads through ``np.memmap``)."""
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    mesh = {"data": 2, "model": 3}
    spec = ("data", "model", None)
    blocks = {(d, m): shd.local_shard(x, spec, {"data": d, "model": m}, mesh)
              for d in range(2) for m in range(3)}
    rows = [torch.cat([blocks[(d, m)] for m in range(3)], 1) for d in range(2)]
    assert torch.equal(torch.cat(rows, 0), x)
    assert shd.local_index(x.shape, spec, {"data": 1, "model": 2}, mesh) == (
        slice(4, 8), slice(4, 6), slice(0, 4))
    # a dim over two axes splits over them major to minor
    assert shd.local_index((8, 6), (("data", "model"), None), {"data": 1, "model": 0},
                           {"data": 2, "model": 2}) == (slice(4, 6), slice(0, 6))
    npx = x.numpy()
    for (d, m), b in blocks.items():
        idx = shd.local_index(npx.shape, spec, {"data": d, "model": m}, mesh)
        assert np.array_equal(npx[idx], b.numpy())
    with pytest.raises(ValueError, match="does not split"):
        shd.local_shard(torch.zeros(5), ("data",), {"data": 0}, {"data": 2})
    # outside a context every model operation is the identity
    y = torch.randn(3, 4)
    for fn in (shd.tp_copy, shd.tp_reduce, shd.data_sum, shd.tp_max):
        assert fn(y) is y
    assert shd.tp_gather(y, -1) is y and shd.tp_split(y, 0) is y


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "falcon-mamba-7b", "zamba2-2.7b",
                                  "qwen2.5-32b", "internvl2-1b"])
def test_a_placed_init_is_the_ranks_block_of_the_whole_init(arch):
    """``init_params`` with a rank's ``Placer`` (each stacked matrix drawn
    whole and cut, so no rank holds a whole leaf) gives, bit for bit, the
    rank's block of the whole init from the same seed."""
    import itertools

    cfg = registry.get_smoke_config(arch)
    whole = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for mesh in ({"data": 2, "model": 2}, {"data": 1, "model": 4}, {"data": 4}):
        rules = shd.make_rules(cfg, mesh)
        specs = shd.param_specs(cfg, rules, whole)
        for c in itertools.product(*[range(v) for v in mesh.values()]):
            coords = dict(zip(mesh, c))
            got = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                          place=shd.Placer(cfg, rules, coords))
            want = port_spec_leaves({k: v for k, v in _blocks(whole, specs, coords,
                                                               mesh).items()})
            have = port_spec_leaves(got)
            assert sorted(have) == sorted(want)
            for k, v in want.items():
                assert torch.equal(have[k], v), (mesh, coords, k)


def _blocks(tree, specs, coords, mesh):
    return {k: _blocks(v, specs[k], coords, mesh) if isinstance(v, dict)
            else shd.local_shard(v, specs[k], coords, mesh) for k, v in tree.items()}
