"""The one-shot weighted merge of the staleness-adaptive aggregation
family (SEAFL, CSAFL, folded FedAsync):

    new_global = (1 - sum(wrow)) * global + sum_k wrow[k] * trained[k]

on pre-padded pack buffers, one launch per round whatever the model's
depth.  ``weighted_merge_packed`` takes one run's [m, N] uploads;
``weighted_merge_packed_fleet`` a fleet's [S, m, N] in one launch, member
s's result bit for bit the single-run launch's on member s's slices.  On
CUDA tensors a wrapper launches its kernel of ``csrc/weighted_merge.cu``
into a fresh output; on CPU tensors it runs the plain version in
``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels.comm_quant import _check_packed
from repro_torch.kernels.safa_aggregate import _lead

#: In-place inventory (format: ``comm_quant.ALIAS_CONTRACTS``): the merge
#: writes a fresh output.
ALIAS_CONTRACTS = {
    'weighted_merge_packed': ((),),
    'weighted_merge_packed_fleet': ((),),
}


def _merge(key: str, entry: str, fleet: bool, trained, global_prev, wrow):
    lead = _lead(trained, fleet)
    m, n = trained.shape[-2:]
    _check_packed(n)
    if not backend.is_cuda(trained, global_prev, wrow):
        return ref.weighted_merge_ref(trained, global_prev, wrow)
    dev = trained.device
    backend.check_operand(trained, 'trained', torch.float32, lead + (m, n),
                          dev)
    backend.check_operand(global_prev, 'global_prev', torch.float32,
                          lead + (n,), dev)
    backend.check_operand(wrow, 'wrow', torch.float32, lead + (m,), dev)
    out = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    backend.call(entry, dev, trained.data_ptr(), global_prev.data_ptr(),
                 wrow.data_ptr(), out.data_ptr(), *lead, m, n)
    backend.LAUNCHES[key] += 1
    return out


def weighted_merge_packed(trained, global_prev, wrow):
    """trained: [m, N] f32 packed uploads (N % PACK_TILE == 0);
    global_prev: [N] f32; wrow: [m] f32 effective merge weights (0 for
    non-commits, sum <= 1).  Returns the new global [N], one launch."""
    return _merge('weighted_merge_packed', 'weighted_merge_f32', False,
                  trained, global_prev, wrow)


def weighted_merge_packed_fleet(trained, global_prev, wrow):
    """Fleet form: trained [S, m, N], global_prev [S, N], wrow [S, m] ->
    new globals [S, N], all S members' merges in one launch."""
    return _merge('weighted_merge_packed_fleet', 'weighted_merge_fleet_f32',
                  True, trained, global_prev, wrow)
