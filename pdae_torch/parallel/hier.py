"""The hierarchical layout of FSDP (``runner_config.mesh_layout: hier``): the
port of ``pdae_tpu/parallel/mesh.py``'s ``make_hier_mesh``. The ranks form a
``[rows, cols]`` grid (``parallel.hier_coords``): a row is a host's ranks,
over which the FSDP plan shards (JAX's ``ici`` axis), a column the same card
of every host (``dcn``), over which each block is replicated. The batch
shards over the whole world in rank order."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from . import dist as pdist
from .mesh import hier_coords


@dataclasses.dataclass
class Groups:
    """This rank's place on the grid and its two groups (None where no
    tensor group exists)."""
    rows: int
    cols: int
    row: int
    col: int
    row_group: object = None
    col_group: object = None


_GROUPS: Dict[Tuple[int, int], Groups] = {}


def hier_groups(rows: int, cols: int) -> Groups:
    """The ``[rows, cols]`` grid over the processes and its row and column
    groups, made once per shape on every rank in the same order
    (``new_group`` is collective)."""
    rank, world = pdist.process_index(), pdist.process_count()
    row, col = hier_coords(rank, world, rows, cols)
    if (rows, cols) in _GROUPS:
        return _GROUPS[(rows, cols)]
    groups = Groups(rows, cols, row, col)
    if pdist.tensor_backend() is not None:
        whole = pdist.tensor_group()

        def made(ranks: Sequence[int]) -> Optional[object]:
            return whole if len(ranks) == world else pdist.new_tensor_group(ranks)
        by_row = [made(range(r * cols, (r + 1) * cols)) for r in range(rows)]
        by_col = [made(range(c, world, cols)) for c in range(cols)]
        groups.row_group, groups.col_group = by_row[row], by_col[col]
    _GROUPS[(rows, cols)] = groups
    return groups


def piece_index(g: Groups):
    """``training.fsdp.local_pieces``'s ``index`` under ``hier``: a split dim
    holds this rank's column's block, written by the ranks of row 0 (replica
    0); a leaf that is whole everywhere is written by rank 0."""
    def index(want, split_dims):
        if split_dims:
            return {d: g.col for d in split_dims}, g.row == 0
        return {}, g.row == 0 and g.col == 0
    return index
