"""Layer stacks for training and serving (port of
``repro.models.transformer``, every family):
the plain attention stack (llama, qwen2.5 with its qkv biases, minicpm,
mixtral's window on every layer, the vlm backbone of internvl2, and
hubert's bidirectional encoder, ``family="audio"``, trained only, with a
two-matrix gelu MLP and its frames projected by ``frame_proj``), gemma3's
grouped stack of G groups of (``pattern_local`` local layers with a
``local_window``-token window and RoPE theta ``rope_theta``, then one
global layer with no window and theta ``rope_theta_global``), the
attention-free mamba1 stack of falcon-mamba (``family="ssm"``), and
zamba2's hybrid stack (``family="hybrid"``): G groups of ``attn_every``
mamba2 layers, each group followed by one attention + MLP block whose
weights all groups share (no window, theta ``rope_theta``), with a KV
cache of its own for each of its G applications.  The moe family
(mixtral, llama4-scout) replaces each layer's MLP with ``models.moe``'s
experts.

Parameters are a plain dict of tensors in the reference's ``x @ W``
layout, each layer's tensors stacked on leading layer axes::

    embed [V, d], final_norm [d], (lm_head [d, V] unless tied),
    (patch_proj [1024, d] with the vision frontend, frame_proj [80, d]
    with the audio one),
    layers [L, ...]                       (plain stack: dense, moe, vlm or ssm)
    local_layers [G, P, ...], global_layers [G, ...]   (grouped stack)
    mamba_groups [G, k, ...] (ln [d] and the mamba2 leaves of ``models.ssm``)
    and shared_attn (one attention layer's leaves, not stacked)  (hybrid)
    attention: wq [d, H*hd], wk/wv [d, KV*hd], wo [H*hd, d], ln1/ln2 [d],
           (bq [H*hd], bk/bv [KV*hd] with qkv_bias)
    dense MLP: w1/w3 [d, f], w2 [f, d] (gelu: w1 and w2 only)
    moe:   router [d, E] fp32, w1/w3 [E, d, f], w2 [E, f, d]
    ssm:   ln [d] and the mamba1 leaves of ``models.ssm``

MoE tokens are routed as the reference routes them on each path: the
full-sequence forward (``forward_last_logits``, ``forward_train``) in
groups of a sequence with capacity drops (``moe.moe_apply``); serving
(``forward_prefill``, both decode steps) a token a group, as the
reference's decode step, which its admission prefill scans over the
prompt, routes them (``moe.moe_tokens``: nothing is dropped).

Interfaces:
  init_params(cfg, generator, device)                         -> params
  forward_train(params, batch, cfg, remat, boundary)          -> (loss, metrics)
                                      (remat: "none", "full" or "dots")
  init_cache(cfg, batch, max_len, device)                     -> cache
  forward_prefill(params, tokens, cfg)                        -> (logits, cache)
  forward_last_logits(params, tokens, cfg)                    -> logits
  forward_decode(params, tokens, cache, lengths, cfg, write_ok) -> (logits, cache)
  forward_decode_paged(params, tokens, pages, tables, lengths, cfg, ...)
                                                  -> (logits, pages, slot_state)

With ``cfg.kv_cache_dtype == "int8"`` (the plain stack) the cache keeps
int8 K/V rows and an fp32 scale per (token, head), ``k_scale``/``v_scale``
[L, B, W, KV]; attention reads the rows dequantized.

A Python loop over :func:`layer_specs` replaces the reference's nested
``lax.scan``, and an explicit batch dimension with per-sequence lengths
replaces its ``vmap`` over slots.  Cache writes update the given tensors
in place (the reference returns new arrays): a decode tick writes one row
per sequence, so copying the pool would cost more than the tick.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import moe, ssm
from repro_torch.models.attention import attention, decode_attention, out_project, qkv_project
from repro_torch.models.config import ModelConfig
from repro_torch.models.frontends import AUDIO_FEAT_DIM, VISION_EMBED_DIM
from repro_torch.models.layers import (
    dense_init,
    dtype_of,
    embed_init,
    keep,
    mlp_apply,
    mlp_init,
    rmsnorm,
)

# stacked parameter trees and the number of leading layer axes of each
STACKS = {"layers": 1, "local_layers": 2, "global_layers": 1, "mamba_groups": 2}
# cache leaves that hold a recurrent state per layer and slot, not rows per
# position: mamba1's, and the hybrid stack's mamba2 state
STATE_LEAVES = ("h", "conv", "m_h", "m_conv")
MAMBA2_STATE = {"h": "m_h", "conv": "m_conv"}  # mamba2 state key -> cache leaf


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Where one layer's weights and cache live, and how it attends."""

    stack: str  # params key (a key of STACKS)
    cache: str  # cache key prefix: "", "local_" or "global_"
    index: tuple  # index into the stack's leading layer axes
    flat: int  # the same index with those axes flattened
    theta: float  # RoPE theta
    window: Optional[int]  # attention window (None: the whole prefix)


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    """Every layer in forward order."""
    if not cfg.pattern_local:
        return [LayerSpec("layers", "", (i,), i, cfg.rope_theta, cfg.sliding_window)
                for i in range(cfg.n_layers)]
    P = cfg.pattern_local
    theta_g = cfg.rope_theta_global or cfg.rope_theta
    specs = []
    for g in range(cfg.n_groups):
        specs += [LayerSpec("local_layers", "local_", (g, p), g * P + p, cfg.rope_theta,
                            cfg.local_window) for p in range(P)]
        specs.append(LayerSpec("global_layers", "global_", (g,), g, theta_g, None))
    return specs


def layer_params(params, cfg: ModelConfig) -> list[dict[str, torch.Tensor]]:
    """Each layer's parameters in forward order (the hybrid stack: its
    mamba2 layers, group by group).  Every stacked leaf is unbound once
    (views), so autograd stacks its gradient in one pass.  In a ``gspmd``
    world a layer's FSDP blocks are all-gathered as the layer reads them
    (``sharding.layer_leaves``)."""
    views = {
        stack: {k: v.flatten(0, STACKS[stack] - 1).unbind(0) for k, v in params[stack].items()}
        for stack in STACKS if stack in params
    }
    if cfg.family == "hybrid":
        return [shd.layer_leaves("mamba_groups",
                                 {k: leaves[i] for k, leaves in views["mamba_groups"].items()})
                for i in range(cfg.n_layers)]
    return [shd.layer_leaves(s.stack, {k: leaves[s.flat] for k, leaves in views[s.stack].items()})
            for s in layer_specs(cfg)]


def shared_spec(cfg: ModelConfig, g: int) -> LayerSpec:
    """The hybrid stack's shared block at its application after group g:
    one set of weights (``shared_attn``), the cache of application g."""
    return LayerSpec("shared_attn", "attn_", (g,), g, cfg.rope_theta, None)


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------


def _layer_stack(gen, lead: tuple, cfg: ModelConfig, dtype, device,
                 place=keep) -> dict[str, torch.Tensor]:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    zeros = torch.zeros(lead + (d,), dtype=dtype, device=device)
    p = {
        "wq": place.dense("wq", gen, lead + (d, cfg.n_heads * hd), dtype),
        "wk": place.dense("wk", gen, lead + (d, cfg.n_kv_heads * hd), dtype),
        "wv": place.dense("wv", gen, lead + (d, cfg.n_kv_heads * hd), dtype),
        "wo": place.dense("wo", gen, lead + (cfg.n_heads * hd, d), dtype,
                          fan_in=cfg.n_heads * hd),
        "ln1": place("ln1", zeros.clone()),
        "ln2": place("ln2", zeros.clone()),
    }
    if cfg.qkv_bias:  # zeros, as the reference initialises them
        for n, width in (("bq", cfg.qk_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            p[n] = place(n, torch.zeros(lead + (width,), dtype=dtype, device=device))
    if cfg.family == "moe":
        p.update(moe.moe_init(gen, lead, cfg, dtype, place))
        return p
    p.update(mlp_init(gen, lead, d, f, dtype, cfg.act, place))
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda",
                place=keep) -> dict[str, Any]:
    """Random weights with the reference's distributions, drawn from
    ``generator`` on ``device`` (the generator must live on that device).
    ``place`` keeps each leaf as it is made (``place(name, leaf)``, or
    ``place.dense`` for a random matrix stack): a world rank's block of it
    (``sharding.Placer``: a stacked leaf is drawn a matrix at a time and
    only the rank's block of each kept), so no rank holds a whole leaf."""
    device = resolve_device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on {device}")
    dtype = dtype_of(cfg.param_dtype)
    params: dict[str, Any] = {
        "embed": place("embed", embed_init(generator, (cfg.vocab, cfg.d_model), dtype)),
        "final_norm": place("final_norm",
                            torch.zeros((cfg.d_model,), dtype=dtype, device=device)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = place.dense("lm_head", generator, (cfg.d_model, cfg.vocab), dtype)
    if cfg.family == "ssm":
        layers = ssm.mamba1_init(generator, (cfg.n_layers,), cfg, dtype, place)
        layers["ln"] = place("ln", torch.zeros((cfg.n_layers, cfg.d_model), dtype=dtype,
                                               device=device))
        params["layers"] = layers
    elif cfg.family == "hybrid":
        lead = (cfg.n_groups, cfg.attn_every)
        groups = ssm.mamba2_init(generator, lead, cfg, dtype, place)
        groups["ln"] = place("ln", torch.zeros(lead + (cfg.d_model,), dtype=dtype,
                                               device=device))
        params["mamba_groups"] = groups
        params["shared_attn"] = {k: v[0] for k, v in _layer_stack(generator, (1,), cfg, dtype,
                                                                     device, place).items()}
    elif cfg.pattern_local:
        G = cfg.n_groups
        params["local_layers"] = _layer_stack(generator, (G, cfg.pattern_local), cfg, dtype,
                                              device, place)
        params["global_layers"] = _layer_stack(generator, (G,), cfg, dtype, device, place)
    else:
        params["layers"] = _layer_stack(generator, (cfg.n_layers,), cfg, dtype, device, place)
    if cfg.frontend == "vision":
        params["patch_proj"] = place.dense("patch_proj", generator,
                                           (VISION_EMBED_DIM, cfg.d_model), dtype)
    elif cfg.frontend == "audio":
        params["frame_proj"] = place.dense("frame_proj", generator,
                                           (AUDIO_FEAT_DIM, cfg.d_model), dtype)
    return params


def param_shapes(cfg: ModelConfig) -> dict[str, Any]:
    """:func:`init_params`'s dict with fake leaves: the shapes and types,
    no memory (for the sharding specs of a full-width config)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return init_params(cfg, torch.Generator(), "cpu")


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _lookup(table, tokens, cfg):
    """``table[tokens]``; under TP with the vocabulary sharded, each rank's
    masked lookup in its own rows, summed over ``"model"``."""
    if not shd.tp_dim(cfg.vocab):
        return table[tokens]
    rows = table.shape[0]
    local = tokens - shd.tp_axis().rank * rows
    hit = (local >= 0) & (local < rows)
    return shd.tp_reduce(table[local.clamp(0, rows - 1)] * hit[..., None].to(table.dtype))


def _embed(params, tokens, cfg):
    return _lookup(params["embed"], tokens, cfg).to(dtype_of(cfg.compute_dtype))


def _embed_inputs(params, tokens, cfg, patches=None):
    """Token embeddings, after the projected vision patches [B, P, 1024]
    when given (the vision frontend's stub output).  Returns (x [B, S, d]
    in the compute type, the label offset P).  Serving passes no patches,
    as the reference's serving never does."""
    if patches is None:
        return _embed(params, tokens, cfg), 0
    if cfg.frontend != "vision":
        raise ValueError(f"{cfg.name}: patches need the vision frontend")
    proj = params["patch_proj"]
    x = torch.cat([patches.to(proj.dtype) @ proj, _lookup(params["embed"], tokens, cfg)], dim=1)
    return x.to(dtype_of(cfg.compute_dtype)), patches.shape[1]


def _train_inputs(params, batch, cfg):
    """A train batch's stack input and label offset: the audio frontend's
    ``frames`` [B, S, 80] through ``frame_proj`` (in the promoted type of
    the two, as the reference's ``@``; no tokens, no offset), else
    :func:`_embed_inputs` of ``tokens`` (and ``patches``)."""
    if cfg.frontend == "audio":
        frames, proj = batch["frames"], params["frame_proj"]
        dt = torch.promote_types(frames.dtype, proj.dtype)
        return (frames.to(dt) @ proj.to(dt)).to(dtype_of(cfg.compute_dtype)), 0
    return _embed_inputs(params, batch["tokens"], cfg, batch.get("patches"))


def _local_logits(params, x, cfg):
    """(fp32 logits over this rank's vocabulary, its first id): the whole
    vocabulary and 0, or under TP with the vocabulary sharded the head's
    column-parallel part."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if not shd.tp_dim(cfg.vocab):
        return (x @ head).float(), 0
    return (shd.tp_copy(x) @ head).float(), shd.tp_axis().rank * head.shape[-1]


def _logits(params, x, cfg):
    """fp32 logits over the whole vocabulary (gathered over ``"model"``
    under TP, so every rank takes the same greedy token)."""
    logits, _ = _local_logits(params, x, cfg)
    return shd.tp_gather(logits, -1) if shd.tp_dim(cfg.vocab) else logits


MOE_GROUPS = ("token", "sequence")


def _mlp_block(lp, x, cfg, *, moe_groups: str = "token", stats=None):
    """x + the layer's MLP of norm(x): SwiGLU (gelu with ``cfg.act``), or
    the moe family's experts with a token a group (serving) or a sequence a
    group (``moe_apply``, whose aux loss is added to ``stats["aux"]``)."""
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family != "moe":
        return x + mlp_apply(lp, h, cfg.act)
    if moe_groups == "token":
        return x + moe.moe_tokens(lp, h, cfg, stats)
    y, aux = moe.moe_apply(lp, h, cfg, stats=stats)
    if stats is not None:
        stats["aux"] = stats.get("aux", 0) + aux
    return x + y


def _decoder_layer(lp, x, cfg, positions, spec: LayerSpec, kv_int8: bool = False, *,
                   moe_groups: str = "sequence", stats=None):
    """One full-sequence layer (causal unless ``cfg.causal`` is False, the
    audio encoder): x [B, S, d] -> (x, k, v), with k/v [B, S, KV, hd]
    after RoPE (what the layer's cache keeps).

    ``kv_int8``: K and V are quantized to the int8 cache's rows before the
    attention, which reads them dequantized, as the reference's decode
    step reads each prompt position's own row from its int8 cache; k/v are
    then ``(rows, scales)`` pairs.  ``moe_groups``/``stats``: see
    :func:`_mlp_block`."""
    B, S = x.shape[:2]
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(lp, h, cfg, positions, spec.theta)
    if kv_int8:
        k, v = quant_heads(k), quant_heads(v)
        k_at, v_at = (dequant(*kv, q.dtype) for kv in (k, v))
    else:
        k_at, v_at = k, v
    o = attention(q, k_at, v_at, causal=cfg.causal, window=spec.window, impl=cfg.attn_impl,
                  chunk=min(cfg.attn_chunk, S))
    x = x + out_project(o.reshape(B, S, -1), lp["wo"], cfg)
    return _mlp_block(lp, x, cfg, moe_groups=moe_groups, stats=stats), k, v


def _layer_output(lp, x, cfg, positions, spec: LayerSpec):
    """x after one attention layer, and its moe aux loss (None outside the
    moe family): the body a recomputed layer runs.  Its moe counters stay
    in a dict of its own, which a recompute fills again."""
    stats = {} if cfg.family == "moe" else None
    x = _decoder_layer(lp, x, cfg, positions, spec, stats=stats)[0]
    return x, None if stats is None else stats["aux"]


def _shared_output(lp, x, cfg, positions, spec: LayerSpec):
    return _decoder_layer(lp, x, cfg, positions, spec)[0]


def _mamba_output(lp, x, cfg):
    return _mamba_block(lp, x, cfg)[0]


def _mamba2_output(lp, x, cfg):
    return x + ssm.mamba2_apply(lp, rmsnorm(x, lp["ln"], cfg.norm_eps), cfg)[0]


# ---------------------------------------------------------------------------
# Rematerialization
# ---------------------------------------------------------------------------

REMAT = ("none", "full", "dots")
# the ops whose outputs "dots" keeps: the weight products, [B, S, d] @ W,
# which eager matmul folds into mm (the reference's
# dots_with_no_batch_dims_saveable); attention's batched einsums (bmm) and
# the experts' are recomputed, as everything else is
DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in DOTS_SAVED else CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(fn, remat: str, *args):
    """``fn(*args)``, its activations kept (``"none"``), recomputed in the
    backward pass (``"full"``: ``torch.utils.checkpoint``, the reference's
    ``nothing_saveable``), or recomputed but for the weight products
    (``"dots"``: a selective checkpoint)."""
    if remat == "none":
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat {remat!r} not in {REMAT}")


def _prefill_rows(leaf, rows):
    """Write a prompt's K or V rows ``[B, S, KV, hd]`` (or int8 scales
    ``[B, S, KV]``) into a cache leaf ``[B, W, ...]`` (W <= S): a rolling
    window keeps the last W positions, position p at row p % W, as the
    decode step writes them."""
    S, W = rows.shape[1], leaf.shape[1]
    leaf.copy_(torch.roll(rows[:, S - W:], shifts=(S - W) % W, dims=1))


def _mamba_block(lp, x, cfg):
    """One full-sequence mamba1 layer: x [B, S, d] -> (x, its final state)."""
    y, state = ssm.mamba1_apply(lp, rmsnorm(x, lp["ln"], cfg.norm_eps), cfg)
    return x + y, state


def _run_mamba_stack(params, x, cfg, *, cache, remat: str = "none"):
    for i, lp in enumerate(layer_params(params, cfg)):
        if cache is None:
            x = remat_call(functools.partial(_mamba_output, cfg=cfg), remat, lp, x)
            continue
        x, state = _mamba_block(lp, x, cfg)
        if cache is not None:
            for n in ("h", "conv"):
                cache[n][i].copy_(state[n])
    return x


def _run_hybrid_stack(params, x, cfg, *, cache, remat: str = "none"):
    """Each group's mamba2 layers (``x + mamba2(norm(x))``), then the shared
    block (causal attention through ``attention``, the flash kernel on the
    card, and the MLP); with ``cache`` each mamba2 layer's final state and
    each application's K/V rows are kept there.  Without, ``remat``
    applies to each mamba2 layer and each application of the shared
    block, as the reference's."""
    positions = torch.arange(x.shape[1], device=x.device)
    k = cfg.attn_every
    mamba = layer_params(params, cfg)
    for g in range(cfg.n_groups):
        if cache is None:
            for i in range(k):
                x = remat_call(functools.partial(_mamba2_output, cfg=cfg), remat,
                               mamba[g * k + i], x)
            x = remat_call(functools.partial(_shared_output, cfg=cfg, positions=positions,
                                             spec=shared_spec(cfg, g)),
                           remat, params["shared_attn"], x)
            continue
        for i in range(k):
            lp = mamba[g * k + i]
            y, state = ssm.mamba2_apply(lp, rmsnorm(x, lp["ln"], cfg.norm_eps), cfg)
            x = x + y
            if cache is not None:
                for n, leaf in MAMBA2_STATE.items():
                    cache[leaf][g, i].copy_(state[n])
        x, kk, vv = _decoder_layer(params["shared_attn"], x, cfg, positions, shared_spec(cfg, g))
        if cache is not None:
            _prefill_rows(cache["attn_k"][g], kk)
            _prefill_rows(cache["attn_v"][g], vv)
    return x


def _run_stack(params, x, cfg, *, remat: str = "none", cache=None, moe_groups="sequence",
               stats=None):
    """Every layer over the full sequence x [B, S, d]; with ``cache`` (the
    :func:`init_cache` layout for max_len S) each layer's K/V rows (mamba1:
    its final state) are kept there.  ``moe_groups``/``stats``: see
    :func:`_mlp_block`.  ``remat`` (no cache) recomputes each layer in
    the backward pass (:func:`remat_call`), where the reference's
    ``maybe_remat`` wraps its scan bodies; a recomputed moe layer adds
    only its aux loss to ``stats``."""
    if moe_groups not in MOE_GROUPS:
        raise ValueError(f"moe_groups {moe_groups!r} not in {MOE_GROUPS}")
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    if remat != "none" and cache is not None:
        raise ValueError("a recomputed stack keeps no cache")
    if cfg.family == "hybrid":
        return _run_hybrid_stack(params, x, cfg, cache=cache, remat=remat)
    if cfg.family == "ssm":
        return _run_mamba_stack(params, x, cfg, cache=cache, remat=remat)
    positions = torch.arange(x.shape[1], device=x.device)
    kv_int8 = cache is not None and "k_scale" in cache
    for spec, lp in zip(layer_specs(cfg), layer_params(params, cfg)):
        if remat != "none":
            fn = functools.partial(_layer_output, cfg=cfg, positions=positions, spec=spec)
            x, aux = remat_call(fn, remat, lp, x)
            if aux is not None and stats is not None:
                stats["aux"] = stats.get("aux", 0) + aux
            continue
        x, k, v = _decoder_layer(lp, x, cfg, positions, spec, kv_int8, moe_groups=moe_groups,
                                 stats=stats)
        if cache is None:
            continue
        for n, kv in (("k", k), ("v", v)):
            rows, scale = kv if kv_int8 else (kv, None)
            _prefill_rows(cache[spec.cache + n][spec.index], rows)
            if kv_int8:
                _prefill_rows(cache[n + "_scale"][spec.index], scale)
    return x


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def _train_head(params, x, batch, cfg: ModelConfig, label_offset: int = 0):
    """Final norm + tied/untied logits + token cross-entropy on the stack
    output ``x`` (past its first ``label_offset`` positions: the vision
    patches); labels < 0 are masked.  Returns (loss, metrics) with the
    per-sequence mean loss ``per_example`` [B].

    Under TP with the vocabulary sharded the cross-entropy is
    vocabulary-parallel: each rank's logits stay local, and the max, the
    sum of exponentials and the label's logit cross ``"model"``.  In a
    world with data ranks the token count is the global batch's, so the
    returned loss is this rank's share of the global mean (the data ranks'
    gradients sum to the global batch's) and ``metrics["loss"]`` the
    global mean."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if label_offset:
        x = x[:, label_offset:]
    logits, lo = _local_logits(params, x, cfg)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    m = shd.tp_max(logits.detach().amax(dim=-1, keepdim=True))
    shifted = logits - m
    lse = torch.log(shd.tp_reduce(torch.exp(shifted).sum(dim=-1)))
    if shd.tp_dim(cfg.vocab):
        idx = labels.clamp(min=0) - lo
        hit = (idx >= 0) & (idx < logits.shape[-1])
        picked = shifted.gather(-1, idx.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        ll = shd.tp_reduce(picked * hit) - lse
    else:
        ll = shifted.gather(-1, labels.clamp(min=0)[..., None])[..., 0] - lse
    ntok = shd.data_sum(mask.sum()).clamp(min=1.0)
    loss = -(ll * mask).sum() / ntok
    per_example = -(ll * mask).sum(-1) / mask.sum(-1).clamp(min=1.0)
    total = loss if shd.data_axis() is None else shd.data_sum(loss.detach())
    return loss, {"loss": total, "ntok": ntok, "per_example": per_example}


def forward_train(params, batch, cfg: ModelConfig, remat: str = "none", boundary=None):
    """Token loss of ``batch``: ``tokens``/``labels`` [B, S] (and
    ``patches`` [B, P, 1024] with the vision frontend: the labels are those
    of the tokens after the patches), or, for the audio encoder, ``frames``
    [B, S, 80] and per-frame ``labels`` [B, S].

    ``remat`` (:func:`remat_call`, per layer): ``"none"`` keeps every
    activation, ``"full"`` recomputes each layer in the backward pass,
    ``"dots"`` keeps only its weight products.  Returns (loss, metrics);
    for the moe family the loss is the token loss + 0.01 x the layers'
    summed aux loss (``metrics["loss"]`` the token loss,
    ``metrics["aux_loss"]`` the aux), as the reference's.

    ``boundary(name, t) -> t``, where given, sees the stack's input
    (``"x0"``), its output (``"x1"``) and the moe aux loss (``"aux"``), and
    returns what the rest of the forward reads: the segmented backward
    (``gradsync.overlap``) cuts the graph there."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r} not in {REMAT}")
    bound = boundary or (lambda _, t: t)
    x, off = _train_inputs(params, batch, cfg)
    stats = {} if cfg.family == "moe" else None
    x = _run_stack(params, bound("x0", x), cfg, remat=remat, stats=stats)
    loss, metrics = _train_head(params, bound("x1", x), batch, cfg, off)
    if stats is None:
        return loss, metrics
    metrics["aux_loss"] = aux = bound("aux", stats["aux"])
    return loss + 0.01 * aux, metrics


# ---------------------------------------------------------------------------
# Contiguous cache: prefill and decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    """Contiguous KV cache.  Plain stack: ``k``/``v`` [L, batch, W, KV, hd]
    with W = min(max_len, sliding_window); an int8 cache adds the fp32
    ``k_scale``/``v_scale`` [L, batch, W, KV].  Grouped stack: ``local_k``/
    ``local_v`` [G, P, batch, min(max_len, local_window), KV, hd] and
    ``global_k``/``global_v`` [G, batch, max_len, KV, hd].  A windowed
    leaf is a rolling buffer: position p lives at row p % W.  mamba1: the
    recurrent state, ``h`` [L, batch, di, N] fp32 and ``conv`` [L, batch,
    K-1, di] in the compute type, whatever ``max_len``.  Hybrid: the
    :func:`init_state` of its mamba2 layers and the shared block's K/V of
    each application, ``attn_k``/``attn_v`` [G, batch, max_len, KV, hd]."""
    device = resolve_device(device)
    if cfg.family == "ssm":
        return init_state(cfg, batch, device)
    tail = (shd.attn_heads(cfg)[1], cfg.head_dim)  # this rank's K/V heads under TP
    if cfg.family == "hybrid":
        shape = (cfg.n_groups, batch, max_len) + tail
        dtype = dtype_of(cfg.compute_dtype)
        return {**init_state(cfg, batch, device),
                **{n: torch.zeros(shape, dtype=dtype, device=device)
                   for n in ("attn_k", "attn_v")}}
    if cfg.pattern_local:
        G, Wl = cfg.n_groups, min(max_len, cfg.local_window or max_len)
        shapes = {"local_": (G, cfg.pattern_local, batch, Wl) + tail,
                  "global_": (G, batch, max_len) + tail}
    else:
        shapes = {"": (cfg.n_layers, batch, min(max_len, cfg.sliding_window or max_len)) + tail}
    int8 = cfg.kv_cache_dtype == "int8"
    dtype = torch.int8 if int8 else dtype_of(cfg.compute_dtype)
    cache = {prefix + n: torch.zeros(shape, dtype=dtype, device=device)
             for prefix, shape in shapes.items() for n in ("k", "v")}
    if int8:  # the plain stack only (ModelConfig refuses the others)
        for n in ("k_scale", "v_scale"):
            cache[n] = torch.zeros(shapes[""][:-1], dtype=torch.float32, device=device)
    return cache


def init_state(cfg: ModelConfig, batch: int, device="cuda"):
    """The recurrent state a slot carries whatever its length: mamba1's
    ``h``/``conv`` [L, batch, ...]; the hybrid stack's ``m_h`` [G, k,
    batch, nh, hp, N] fp32 and ``m_conv`` [G, k, batch, K-1, di + 2 N] in
    the compute type; nothing for the attention stacks."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.compute_dtype)
    if cfg.family == "ssm":
        L = cfg.n_layers
        state = ssm.mamba1_init_state(cfg, L * batch, dtype, device)
        return {n: t.unflatten(0, (L, batch)) for n, t in state.items()}
    if cfg.family == "hybrid":
        lead = (cfg.n_groups, cfg.attn_every)
        state = ssm.mamba2_init_state(cfg, cfg.n_layers * batch, dtype, device)
        return {MAMBA2_STATE[n]: t.unflatten(0, lead + (batch,)) for n, t in state.items()}
    return {}


def quant_heads(x):
    """x [..., KV, hd] -> (int8 rows [..., KV, hd], fp32 scales [..., KV]):
    a scale per head vector, amax / 127 (1 where the vector is 0); the
    quotient rounded half to even and clipped to +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # a tensor divisor: CUDA's division by a Python number multiplies by its
    # reciprocal, which can differ from true division in the last bit
    scale = torch.where(amax > 0, amax / amax.new_full((), 127.0), torch.ones_like(amax))
    q = torch.div(xf, scale[..., None]).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequant(rows, scale, dtype):
    """int8 rows [..., KV, hd] and scales [..., KV] -> rows in ``dtype``."""
    return (rows.float() * scale[..., None]).to(dtype)


def forward_prefill(params, tokens, cfg: ModelConfig, stats=None):
    """One causal forward over a prompt (serving's admission: moe tokens
    routed a token a group, as the reference's scanned decode step routes
    them).  tokens: [B, S] -> (last-position logits [B, V] fp32, the
    :func:`init_cache` cache of max_len S holding the prompt's K/V rows, or
    its mamba1 state, or the hybrid stack's mamba2 states and its shared
    block's K/V rows of each application)."""
    cache = init_cache(cfg, tokens.shape[0], tokens.shape[1], tokens.device)
    x = _run_stack(params, _embed(params, tokens, cfg), cfg, cache=cache, moe_groups="token",
                   stats=stats)
    x = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), cache


def forward_last_logits(params, tokens, cfg: ModelConfig, *, patches=None, stats=None):
    """Whole-prompt forward that keeps no cache (moe tokens routed a
    sequence a group, with capacity drops): tokens [B, S] (after
    ``patches`` [B, P, 1024] with the vision frontend) -> last-position
    logits [B, V] fp32.  ``stats``: see :func:`_mlp_block`."""
    x, _ = _embed_inputs(params, tokens, cfg, patches)
    x = _run_stack(params, x, cfg, stats=stats)
    x = rmsnorm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg)


def _write_rows(leaf, rows, idx, new, write_ok):
    """leaf[b, idx[b]] = new[b] for every sequence b, or keep the old row
    where ``write_ok[b]`` is False."""
    if write_ok is not None:
        ok = write_ok.reshape((-1,) + (1,) * (new.ndim - 1))
        new = torch.where(ok, new, leaf[rows, idx])
    leaf[rows, idx] = new


def _write_int8_rows(leaf, scales, rows, idx, new, write_ok, dtype):
    """Quantize ``new`` [B, KV, hd] into the int8 ``leaf`` and its
    ``scales`` at row ``idx[b]`` of each sequence (as :func:`_write_rows`);
    returns the whole leaf dequantized to ``dtype``."""
    q, s = quant_heads(new)
    _write_rows(leaf, rows, idx, q, write_ok)
    _write_rows(scales, rows, idx, s, write_ok)
    return dequant(leaf, scales, dtype)


def _decode_mamba_stack(params, x, cache, cfg, write_ok):
    """The mamba1 layers of one decode step; each layer's state in the cache
    is updated in place, except where ``write_ok`` is False."""
    for i, lp in enumerate(layer_params(params, cfg)):
        state = {n: cache[n][i] for n in ("h", "conv")}
        x = x + ssm.mamba1_decode(lp, rmsnorm(x, lp["ln"], cfg.norm_eps), state, cfg, write_ok)
    return x


def _decode_mamba2_group(mamba, g, x, state, cfg, write_ok):
    """Group g's mamba2 layers of one decode step (``mamba``: every layer's
    parameters, :func:`layer_params`); ``state`` holds ``m_h``/``m_conv``,
    updated in place, except where ``write_ok`` is False."""
    k = cfg.attn_every
    for i in range(k):
        lp = mamba[g * k + i]
        st = {n: state[leaf][g, i] for n, leaf in MAMBA2_STATE.items()}
        x = x + ssm.mamba2_decode(lp, rmsnorm(x, lp["ln"], cfg.norm_eps), st, cfg, write_ok)
    return x


def _decode_attn_layer(lp, x, kc, vc, rows, lengths, cfg, spec: LayerSpec, write_ok,
                       scales=None):
    """One attention + MLP layer of a decode step over a contiguous cache
    (kc/vc [B, W, KV, hd], written in place at row ``lengths[b]``, or
    ``lengths[b] % W`` under a window; ``scales``: the int8 cache's k and v
    scale leaves)."""
    B, W = x.shape[0], kc.shape[1]
    idx = lengths % W if spec.window is not None else lengths
    h = rmsnorm(x[:, None], lp["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(lp, h, cfg, lengths[:, None], spec.theta)
    if scales is not None:  # quantized rows and scales in, the whole cache dequantized out
        k_at, v_at = (_write_int8_rows(c, sc, rows, idx, new[:, 0], write_ok, q.dtype)
                      for c, sc, new in ((kc, scales[0], k), (vc, scales[1], v)))
    else:
        _write_rows(kc, rows, idx, k[:, 0], write_ok)
        _write_rows(vc, rows, idx, v[:, 0], write_ok)
        k_at, v_at = kc, vc
    o = decode_attention(q, k_at, v_at, (lengths + 1).clamp(max=W))
    return _mlp_block(lp, x + out_project(o.reshape(B, -1), lp["wo"], cfg), cfg)


def forward_decode(params, tokens, cache, lengths, cfg: ModelConfig, write_ok=None):
    """One decode step over a contiguous cache with a per-sequence length.

    tokens: [B] int; cache: the :func:`init_cache` layout, written in place
    at row ``lengths[b]`` (``lengths[b] % W`` in a rolling window leaf; the
    mamba1 or mamba2 state replaced); lengths: [B] int (positions before this token);
    write_ok: [B] bool (False keeps the sequence's cache rows or state as
    they were).  Returns (logits [B, V] fp32, cache).
    """
    if cfg.family == "ssm":
        x = _decode_mamba_stack(params, _embed(params, tokens, cfg), cache, cfg, write_ok)
        x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return _logits(params, x, cfg), cache
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    lengths = lengths.long()
    x = _embed(params, tokens, cfg)
    if cfg.family == "hybrid":
        mamba = layer_params(params, cfg)
        for g in range(cfg.n_groups):
            x = _decode_mamba2_group(mamba, g, x, cache, cfg, write_ok)
            x = _decode_attn_layer(params["shared_attn"], x, cache["attn_k"][g],
                                   cache["attn_v"][g], rows, lengths, cfg, shared_spec(cfg, g),
                                   write_ok)
    else:
        int8 = "k_scale" in cache
        for spec, lp in zip(layer_specs(cfg), layer_params(params, cfg)):
            scales = ((cache["k_scale"][spec.index], cache["v_scale"][spec.index])
                      if int8 else None)
            x = _decode_attn_layer(lp, x, cache[spec.cache + "k"][spec.index],
                                   cache[spec.cache + "v"][spec.index], rows, lengths, cfg,
                                   spec, write_ok, scales)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), cache


# ---------------------------------------------------------------------------
# Block-paged cache: decode through the paged-attention kernel
# ---------------------------------------------------------------------------


def paged_write_slots(tables, lengths, block_size: int, write_ok=None):
    """Physical (block, offset) of each sequence's next row.

    Sequences with ``write_ok`` False are redirected to the reserved trash
    block 0, so inactive slots never touch a live block.
    """
    lengths = lengths.long()
    pb = tables.long().gather(1, (lengths // block_size)[:, None])[:, 0]
    off = lengths % block_size
    if write_ok is not None:
        pb = torch.where(write_ok, pb, 0)
        off = torch.where(write_ok, off, 0)
    return pb, off


def _paged_attn_layer(lp, x_tok, kp, vp, tables, positions, valid, pb, off, cfg, *,
                      theta: float):
    """One decode layer over block-paged K/V pools.

    x_tok: [S, d]; kp/vp: [N, bs, KV, hd] physical pools of this layer,
    written in place at the precomputed physical (block, offset) ``pb,
    off`` of each sequence's new row; tables: [S, nb] int32; positions:
    [S, 1] absolute position of each token; valid: [S] int32 positions to
    attend over (``lengths + 1``).  The paged-attention kernel reads K/V
    through the block table: no contiguous view is materialized.
    """
    S = x_tok.shape[0]
    h = rmsnorm(x_tok[:, None], lp["ln1"], cfg.norm_eps)
    q, k, v = qkv_project(lp, h, cfg, positions, theta)
    kp[pb, off] = k[:, 0]
    vp[pb, off] = v[:, 0]
    o = paged_attention(q[:, 0].contiguous(), kp, vp, tables, valid)
    x = x_tok + out_project(o.reshape(S, -1), lp["wo"], cfg)
    return _mlp_block(lp, x, cfg)


def forward_decode_paged(params, tokens, pages, tables, lengths, cfg: ModelConfig, *,
                         block_size: int, write_ok=None, slot_state=None):
    """One batched decode step over a block-paged cache.

    tokens: [S] int; pages: ``{"k","v": [L, N, bs, KV, hd]}`` physical
    pools (hybrid: ``attn_k``/``attn_v`` [G, N, bs, KV, hd]), written in
    place; tables: [S, nb] int32; lengths: [S] int32; write_ok: [S] bool
    (False redirects the slot's write to the trash block 0, and keeps its
    recurrent state); slot_state: the per-slot leaves (hybrid: ``m_h``/
    ``m_conv`` of :func:`init_state`, updated in place; none for the other
    families).  Attention reads K/V through the block table inside the
    paged-attention kernel on the card (its plain version on the CPU); all
    other math matches :func:`forward_decode`.  Returns (logits [S, V]
    fp32, pages, slot_state).
    """
    if "k_scale" in pages:
        raise NotImplementedError(
            "int8 paged decode is served by the gather path (attn='gather')"
        )
    pb, off = paged_write_slots(tables, lengths, block_size, write_ok)
    tables = tables.to(torch.int32).contiguous()
    positions = lengths.long()[:, None]
    valid = (lengths + 1).to(torch.int32).contiguous()
    x = _embed(params, tokens, cfg)
    slot_state = {} if slot_state is None else slot_state
    if cfg.family == "hybrid":
        mamba = layer_params(params, cfg)
        for g in range(cfg.n_groups):
            x = _decode_mamba2_group(mamba, g, x, slot_state, cfg, write_ok)
            x = _paged_attn_layer(params["shared_attn"], x, pages["attn_k"][g],
                                  pages["attn_v"][g], tables, positions, valid, pb, off, cfg,
                                  theta=cfg.rope_theta)
    else:
        for spec, lp in zip(layer_specs(cfg), layer_params(params, cfg)):
            x = _paged_attn_layer(lp, x, pages["k"][spec.flat], pages["v"][spec.flat], tables,
                                  positions, valid, pb, off, cfg, theta=spec.theta)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), pages, slot_state
