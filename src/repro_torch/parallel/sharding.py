"""Mesh-axis helpers (the port of the part of ``repro/parallel/sharding.py``
that the multi-rank model paths read: ``dp_axes``; ``dp_size`` and
``model_size`` come with the trainer's mesh, which calls them).

The reference's logical-axis rule sets and their ``NamedSharding``s wait for
the trainer's mesh (ROADMAP queue 1, item 9).  In the port each process is
one rank of a :class:`~repro_torch.launch.mesh.Mesh` and holds its own
blocks of the tensors (the contract is :class:`~repro_torch.models.layers.Ctx`'s),
so what a rule set would say is said by which block a rank is handed:
:func:`batch_block` gives a rank's block of a batch.
"""

from __future__ import annotations


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel mesh axes present in this mesh."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_block(mesh, B: int) -> slice:
    """This rank's block of a batch of ``B``: sharded over the data-parallel
    axes that divide it, taken in order, and replicated over the others, as
    the reference's flash decode shards its batch (a batch of 1 replicates
    over every data axis)."""
    n, idx, rem = 1, 0, B
    for a in dp_axes(mesh):
        size = mesh.shape[a]
        if rem % size == 0:
            idx = idx * size + mesh.axis_index(a)
            n *= size
            rem //= size
    return slice(idx * (B // n), (idx + 1) * (B // n))
