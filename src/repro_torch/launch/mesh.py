"""Production meshes, as data.

A ``Mesh`` is the reference's mesh without devices: ordered axis names
and their sizes, which is all ``sharding.spec_for`` and the dry run
read.  The production meshes are the reference's: 16 x 16 (``data``,
``model``) for one pod, 2 x 16 x 16 (``pod``, ``data``, ``model``) for
two.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.backend import resolve_device


class Mesh:
    """Axis names in order and their sizes; no devices."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f'{len(shape)} sizes for axes {axis_names}')
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.shape.values())

    def __eq__(self, other):
        return (isinstance(other, Mesh)
                and list(self.shape.items()) == list(other.shape.items()))

    def __repr__(self):
        return f'Mesh({describe(self)})'


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ('pod', 'data', 'model') if multi_pod else ('data', 'model')
    return Mesh(shape, axes)


def make_local_mesh(device='cuda') -> Mesh:
    """The mesh of this host's cards with the production axis names, by
    the reference's rule: (n // 2) x 2 for n >= 4 cards, else 1 x 1
    (``device='cpu'``: 1 x 1).  ``'cuda'`` raises without a card."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == 'cuda' else 1
    if n >= 4:
        return Mesh((n // 2, 2), ('data', 'model'))
    return Mesh((1, 1), ('data', 'model'))


def n_clients(mesh: Mesh, client_axes=('pod', 'data')) -> int:
    """Silo-mode federated client count = product of client axes present."""
    c = 1
    for ax in client_axes:
        if ax in mesh.axis_names:
            c *= mesh.shape[ax]
    return c


def describe(mesh: Mesh) -> str:
    return 'x'.join(f'{k}={v}' for k, v in mesh.shape.items())
