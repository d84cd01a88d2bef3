"""A train step's checkpoint layout: what the elastic trainer saves and
restores, decided by the step that holds the state.

Every step class mixes in :class:`Snapshot`:

- on stacked rows (no mesh) a save is the reference's nesting of the
  whole state, the file the reference's trainer writes;
- an MRD world rank writes its rows of the saved ``[n, ...]`` leaves: a
  row a ``"data"`` coordinate, or at ``tp`` > 1 a row a ``("data",
  "model")`` coordinate (row-major), of every part but the step (its
  blocks of the params too), bound to the current mesh at each save and
  restore (``Checkpointer.bind_world``);
- a ``gspmd`` world (``GspmdStep`` overrides the two world methods)
  writes global leaves, streamed to the mesh's root
  (``gspmd.save_global``), and reads each rank's blocks of them.

:meth:`Snapshot.restore` reads the whole state at the saved extent, or
the params alone (``params_only``), which any extent can read.  Both
restore through ``runtime.fault_tolerance.recover``.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def mesh_tp(mesh) -> int:
    """A world mesh's ``"model"`` extent (1 without one, and on stacked
    rows)."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    return mesh.size(names.index("model")) if "model" in names else 1


def _meta(tree):
    """Meta tensors of ``tree``'s leaves (their shapes and types)."""
    from repro_torch.checkpoint.checkpointer import _unflatten, flatten_with_paths

    return _unflatten({k: torch.empty(tuple(torch.as_tensor(v).shape),
                                      dtype=torch.as_tensor(v).dtype, device="meta")
                       for k, v in flatten_with_paths(tree).items()})


class Snapshot:
    """The rows layout of a train step's checkpoints; needs the step's
    ``cfg``, ``tcfg``, ``device`` and ``mesh``."""

    def _replica(self) -> bool:
        return self.tcfg.grad_sync == "local_sgd"

    def _rows(self, state) -> tuple:
        """(a world rank's state as the reference nests it, the parts of it
        that are this rank's rows of the saved leaves)."""
        from repro_torch.models import convert

        tree, rows = convert.rank_state_to_reference(state, replica=self._replica())
        if mesh_tp(self.mesh) > 1:
            rows = tuple(k for k in tree if k != "step")
        return tree, rows

    def bind(self, ck) -> None:
        """Make ``ck`` this process's part of the current mesh's saves and
        restores: a row a coordinate (row-major) of a world, the one
        writer on stacked rows."""
        if self.mesh is None:
            ck.bind_world(None)
            return
        coord = tuple(self.mesh.get_coordinate())
        ck.bind_world((int(np.ravel_multi_index(coord, tuple(self.mesh.mesh.shape))),
                       self.mesh.size()))

    def save(self, ck, step: int, state, extra: dict, *, block: bool) -> None:
        """Snapshot ``state`` as ``step`` with ``extra`` (the data cursor,
        the extent)."""
        from repro_torch.models import convert

        self.bind(ck)
        if self.mesh is None:
            ck.save(step, convert.train_state_to_reference(state), extra=extra, block=block)
            return
        tree, rows = self._rows(state)
        ck.save(step, tree, extra=extra, block=block, rows=rows)

    def restore(self, ck, state, *, params_only: bool = False) -> tuple:
        """(state, RestartReport) of ``ck``'s latest step on this step's
        mesh: the whole state, which the saved extent and strategy must
        be this step's, read in the layout of ``state`` (a fresh one,
        emptied once its shapes are read, so its memory goes first); with
        ``params_only`` (params, RestartReport), ``state`` kept."""
        if params_only:
            return self._restore_params(ck, state["params"])
        from repro_torch.models import convert
        from repro_torch.runtime.fault_tolerance import recover

        self.bind(ck)
        cfg, dp = self.cfg, self.dp
        if self.mesh is None:
            tree, rows = _meta(convert.train_state_to_reference(state)), None
        else:
            tree, rows = self._rows(state)
            tree = _meta(tree)
        state.clear()
        got, report = recover(ck, tree, "cpu", old_dp=dp, new_dp=dp, rows=rows)
        if self.mesh is None:
            return convert.train_state_from_reference(got, cfg, self.device), report
        return convert.rank_state_from_reference(got, cfg, self.device), report

    def _restore_params(self, ck, params) -> tuple:
        """(params, RestartReport) in the layout of ``params``: the leaves
        read whole out of the archive; under ``local_sgd`` (whose replica
        rows were saved at some extent) the first saved replica, repeated
        onto every row on stacked rows; at ``tp`` > 1 (an MRD world saves
        its param blocks as rows of ``[dp x tp, ...]`` leaves) the row of
        this model coordinate at ``"data"`` coordinate 0."""
        from repro_torch.checkpoint.checkpointer import _unflatten, flatten_with_paths, npz_members
        from repro_torch.models import convert
        from repro_torch.runtime.fault_tolerance import recover

        latest = ck.latest_step()
        leaves = flatten_with_paths({"params": convert.reference_tree(params)})
        row = None
        if mesh_tp(self.mesh) > 1:
            row = int(self.mesh.get_coordinate()[list(self.mesh.mesh_dim_names).index("model")])
        elif self._replica():
            row = 0
        if row is not None:
            saved = npz_members(os.path.join(ck.dir, f"step_{latest}", "arrays.npz"))
            leaves = {k: torch.empty(saved[k][0], dtype=v.dtype, device="meta")
                      for k, v in leaves.items()}
        got, report = recover(ck, _unflatten(leaves), self.device,
                              old_dp=ck.manifest(latest)["extra"].get("dp"), new_dp=self.dp,
                              blocks=None if row is None else {k: row for k in leaves})
        out = got["params"]
        if self._replica() and self.mesh is None:
            out = _unflatten({k: v[None].expand((self.dp,) + tuple(v.shape)).clone()
                              for k, v in flatten_with_paths(out).items()})
        return convert.port_tree(out), report
