"""Ready-bucket grad-sync overlap (port of
``repro.distributed.gradsync.overlap``).

The bucketed MRD sync pipelines the collective stages *across* buckets,
but it waits for the whole backward pass before it packs the first one.
This module carries the stage-major pipeline across the backward:

1. :func:`segmented_grads` runs the backward as three
   ``torch.autograd.grad`` segments over detached boundaries, in the
   model's reverse-topological readiness groups: **head**
   (``final_norm``/``lm_head``), **stack** (every stacked layer tree:
   ``layers``, ``local_layers``/``global_layers``, ``mamba_groups``/
   ``shared_attn``) and **embed** (``embed``/``patch_proj``/
   ``frame_proj``), and yields each group's gradients as its segment
   completes.  A stacked leaf's gradient exists only once the whole
   stack's backward is done, so a top-level key is the finest readiness
   the layouts admit without changing them.
2. :func:`drive` consumes those groups, packs each bucket as soon as the
   gradients of all its leaves exist (the same :class:`BucketLayout` as
   the post-backward path: only the order in which buckets enter the
   plan moves, never an element's offset), admits it into the plan's
   :class:`~repro_torch.collectives.plans.BucketPipeline` and advances
   every bucket in flight one stage a group.  On a device a stage's
   messages are waited on at its finish, so the head buckets' stages are
   in flight while the stack's backward runs.

Per bucket the stage math is ``run_buffers``'s and touches only that
bucket's tensors, so the reduced buffers, and the params, moments and EF
residuals after them, equal the post-backward path's bit for bit.

One order differs from the reference's ``drive``: there a group's
buckets are admitted and then every bucket advances (a dataflow graph
for XLA to schedule); here every bucket already in flight advances
first and the group's buckets are admitted after, so a newly admitted
bucket's first stage stays in flight across the next backward segment
instead of being waited on at once.  The stages each bucket runs, and
therefore every value, are the same.
"""

from __future__ import annotations

import torch

from repro_torch.collectives import buckets
from repro_torch.distributed.gradsync import common
from repro_torch.models import convert, transformer

# Readiness groups in backward (reverse-topological) order; a top-level
# key not named here belongs to the layer stack (group 1).
HEAD_KEYS = frozenset({"final_norm", "lm_head"})
EMBED_KEYS = frozenset({"embed", "patch_proj", "frame_proj"})
GROUP_NAMES = ("head", "stack", "embed")
N_GROUPS = len(GROUP_NAMES)


def group_of_key(key: str) -> int:
    if key in HEAD_KEYS:
        return 0
    if key in EMBED_KEYS:
        return 2
    return 1


def key_offsets(params) -> dict[str, int]:
    """The reference flatten index of each top-level key's first leaf
    (keys sorted, a key's leaves contiguous), of the port's tree
    ``params`` (any leaves)."""
    out, off = {}, 0
    ref = convert.reference_tree(params)
    for k in sorted(ref):
        out[k] = off
        off += len(buckets.tree_flatten(ref[k])[0])
    return out


def leaf_groups(params) -> list[int]:
    """Each leaf's readiness group, in the reference's flatten order."""
    ref = convert.reference_tree(params)
    out: list[int] = []
    for k in sorted(ref):
        out.extend([group_of_key(k)] * len(buckets.tree_flatten(ref[k])[0]))
    return out


def bucket_groups(layout: buckets.BucketLayout, lgroups: list[int]) -> list[int]:
    """Each bucket's readiness group: packable once its latest leaf's
    group has emitted."""
    return [max(lgroups[s.index] for s in b.slots) for b in layout.buckets]


def _grads(outputs, inputs, grad_outputs=None) -> list:
    """``torch.autograd.grad`` with a zero gradient for an input the
    outputs do not read."""
    got = torch.autograd.grad(outputs, inputs, grad_outputs=grad_outputs, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(got, inputs)]


def _one_batch_segments(params: dict, batch, cfg, remat: str):
    """The segmented forward of one (micro)batch on ``params`` (leaves that
    require grad): ``transformer.forward_train`` with the graph cut at its
    boundaries.  Returns (loss, metrics, backward): ``backward()`` yields
    ``(group name, {top-level key: gradient subtree})`` in readiness order,
    each gradient in its leaf's type, and keeps no reference to a piece it
    has yielded."""
    keys = [sorted(k for k in params if group_of_key(k) == g) for g in range(N_GROUPS)]
    tied = cfg.tie_embeddings and "embed" in params
    outs, ins = {}, {}

    def boundary(name, t):
        outs[name], ins[name] = t, t.detach().requires_grad_()
        return ins[name]

    with torch.enable_grad():
        loss, metrics = transformer.forward_train(params, batch, cfg, remat, boundary=boundary)
    metrics = {k: v.detach() for k, v in metrics.items()}
    cut = ["x1", "aux"] if "aux" in ins else ["x1"]

    def leaves_of(ks):
        flat = [buckets.tree_flatten(params[k]) for k in ks]
        return [leaf for lv, _ in flat for leaf in lv], flat

    def pieces(ks, flat, grads):
        """``grads`` as a dict of subtrees; empties the list."""
        out, i = {}, 0
        for k, (lv, paths) in zip(ks, flat):
            n = len(lv)
            out[k] = (buckets.tree_unflatten(paths, grads[i:i + n]) if paths != ((),)
                      else grads[i])
            i += n
        grads.clear()
        return out

    def backward():
        with torch.enable_grad():
            head, head_flat = leaves_of(keys[0])
            extra = ([params["embed"]] if tied else []) + [ins[k] for k in cut]
            g = _grads(loss, head + extra)
            g_rest = g[len(head):]
            del g[len(head):]
            g_embed_head = g_rest.pop(0) if tied else None
            yield "head", pieces(keys[0], head_flat, g)
            stack, stack_flat = leaves_of(keys[1])
            g = _grads([outs[k] for k in cut], stack + [ins["x0"]], grad_outputs=g_rest)
            del g_rest
            g_x0 = g.pop()
            yield "stack", pieces(keys[1], stack_flat, g)
            embed, embed_flat = leaves_of(keys[2])
            g = _grads(outs["x0"], embed, grad_outputs=[g_x0])
        if tied:
            # the tied head's share of the embedding's gradient (the group's
            # first leaf): one add of the two contributions, as autograd
            # adds them in one backward
            g[0] = g[0] + g_embed_head
            del g_embed_head
        yield "embed", pieces(keys[2], embed_flat, g)

    return loss.detach(), metrics, backward


def segmented_grads(params, batch, cfg, remat: str, microbatches: int):
    """Generator form of :func:`common.microbatched_grads`: first yields
    ``(mean loss, metrics of the last microbatch)``, then ``(group name,
    gradient piece)`` for head, stack and embed, each piece a dict of
    top-level keys.  Joined, the pieces are ``microbatched_grads``'s
    gradients bit for bit: one microbatch's in the params' types; over
    several, the first ``microbatches - 1`` accumulate in fp32 exactly as
    there and only the last one's backward is segmented, so each piece is
    ``(((g_0 + g_1) + ...) + g_{M-1}) / M``."""
    leaves, treedef = buckets.tree_flatten(params)
    req = [t.detach().requires_grad_() for t in leaves]
    p_req = buckets.tree_unflatten(treedef, req)
    if microbatches == 1:
        loss, metrics, backward = _one_batch_segments(p_req, batch, cfg, remat)
        yield loss, metrics
        yield from backward()
        return
    B = common.batch_size(batch)
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
    mb = B // microbatches

    def part(i):
        return {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}

    acc, loss_sum = None, 0.0
    for i in range(microbatches - 1):
        grads, loss, _ = common.one_microbatch(p_req, req, part(i), cfg, remat)
        if acc is None:
            acc = [g.float() for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g.float())
        loss_sum = loss_sum + loss
    acc = buckets.tree_unflatten(treedef, acc)
    loss, metrics, backward = _one_batch_segments(p_req, part(microbatches - 1), cfg, remat)
    div = loss.new_full((), float(microbatches))  # true division on the card too
    yield (loss_sum + loss) / div, metrics
    for name, piece in backward():
        yield name, _tmap(lambda a, g: (a + g.float()) / div, {k: acc.pop(k) for k in piece},
                          piece)


def _tmap(fn, a, b):
    if isinstance(a, dict):
        return {k: _tmap(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def drive(emitters: list, layout: buckets.BucketLayout, koffsets: dict, bgroups: list, *,
          plan, stacked: bool, wire=None):
    """Consume :func:`segmented_grads` generators, one a rank this process
    computes (every rank's on the sim's stacked rows, ``stacked``; a world
    rank's own), admitting each bucket into ``plan``'s pipeline once its
    readiness group has emitted on every rank and advancing the buckets
    in flight one stage a group.  ``wire(i, buf) -> buf`` maps a packed
    fp32 bucket to its payload (the EF-SGD round trip).  Returns (each
    emitter's (loss, metrics), the reduced buffers in bucket order)."""
    # each rank's forward and head segment before the next rank's forward:
    # on stacked rows the head's activations (the fp32 logits) of one rank
    # at a time, as the post-backward path holds them
    firsts, heads = [], []
    for e in emitters:
        firsts.append(next(e))
        heads.append(next(e))
    leaves = [[None] * layout.n_leaves for _ in emitters]
    lead = (len(emitters),) if stacked else ()
    pipe = plan.pipeline()
    emitted = 0
    for gi in range(N_GROUPS):
        # a group's gradients stay in the params' type until every rank has
        # emitted it, and each bucket's leaves are released as it is packed,
        # as common.stacked_grad_buckets does: packing a rank's fp32 row
        # before the next rank's segment would hold all the rows' fp32
        # through that segment
        for r, e in enumerate(emitters):
            _, piece = heads[r] if gi == 0 else next(e)
            heads[r] = None
            ref = convert.reference_tree(piece)
            for k in sorted(ref):
                for j, leaf in enumerate(buckets.tree_flatten(ref[k])[0]):
                    leaves[r][koffsets[k] + j] = leaf
            del piece, ref
        # the buckets in flight move one stage before this group's enter, so
        # a new bucket's first stage spans the next backward segment
        pipe.advance()
        for bi, bg in enumerate(bgroups):
            if bg != gi:
                continue
            b = layout.buckets[bi]
            device = leaves[0][b.slots[0].index].device
            buf = torch.zeros(lead + (b.length,), dtype=torch.float32, device=device)
            for r in range(len(emitters)):
                buckets.pack_bucket(leaves[r], layout, bi, out=buf[r] if stacked else buf)
                for s in b.slots:
                    leaves[r][s.index] = None
            if wire is not None:
                buf = wire(bi, buf)
            pipe.admit(bi, buf)
            del buf  # the stage's context holds what the pipeline needs
            emitted += 1
    for e in emitters:
        for _ in e:
            raise ValueError("a gradient emitter yielded past its embed group")
    if emitted != len(layout.buckets):
        raise ValueError(f"emitted {emitted} of {len(layout.buckets)} buckets: the readiness "
                         f"groups do not cover the layout")
    done = pipe.drain()
    return firsts, [done[i] for i in range(len(layout.buckets))]


def reduced_buckets(params, batch, cfg, tcfg, dp: int, layout: buckets.BucketLayout, rank,
                    plan, aux=None, wire=None):
    """The overlapped form of ``common.grad_buckets`` followed by
    ``plan.run_buffers``: each rank's segmented backward (every rank's
    shard of the global batch on the sim, ``rank`` None; a world rank's
    own ``batch``) drives ``plan``'s pipeline.  Returns (the reduced
    buffers, the losses [dp] or a rank's 0-d loss, the monitor metrics
    likewise); the moe family's aux loss, the ranks' mean, goes into
    ``aux`` as ``aux_loss``."""
    emitters = [segmented_grads(params, local, cfg, tcfg.remat, tcfg.microbatches)
                for local in common.local_shards(batch, dp, rank)]
    firsts, red = drive(emitters, layout, key_offsets(params), bucket_groups(
        layout, leaf_groups(params)), plan=plan, stacked=rank is None, wire=wire)
    losses = [loss for loss, _ in firsts]
    metrics = [m["per_example"].mean() for _, m in firsts]
    auxes = [m["aux_loss"] for _, m in firsts if "aux_loss" in m]
    if aux is not None and auxes:
        aux["aux_loss"] = torch.stack(auxes).mean() if rank is None else auxes[0]
    if rank is not None:
        return red, losses[0], metrics[0]
    return red, torch.stack(losses), torch.stack(metrics)
