"""One call of every kernel wrapper of the port, with small operands whose
floating-point tensors require grad: the autograd refusal's cases, shared
by the CPU tests (``tests/test_torch_train.py``) and the card tests
(``tests/test_torch_cuda.py``).  Imports no JAX."""
import torch

from repro_torch.kernels import comm_quant as cq
from repro_torch.kernels import rows as rw
from repro_torch.kernels import safa_aggregate as sa
from repro_torch.kernels import weighted_merge as wm
from repro_torch.kernels.swa_attention import swa_attention

M, N, K, R = 2, cq.PACK_TILE, 2, 3      # clients, width, slots, buffer rows


def _operands(dev, lead=()):
    """Seeded operands of one run (``lead=()``) or a fleet (``(2,)``);
    the float tensors require grad."""
    g = torch.Generator().manual_seed(0)

    def f(*shape):
        return torch.randn(lead + shape, generator=g).to(dev).requires_grad_()

    def mask(*shape):
        return torch.ones(lead + shape, dtype=torch.bool, device=dev)
    q = torch.zeros(lead + (M, N), dtype=torch.int8, device=dev)
    return dict(
        cache=f(M, N), trained=f(M, N), global_prev=f(N), weights=f(M),
        picked=mask(M), undrafted=mask(M), deprecated=mask(M),
        completed=mask(M), q=q, scales=f(M, N // cq.QBLOCK), base=f(M, N),
        buf=f(R, N), trained_rows=f(K, N), agg=f(N),
        rows=torch.zeros(lead + (K,), dtype=torch.int32, device=dev),
        roles=torch.zeros(lead + (K,), dtype=torch.uint8, device=dev),
        w_rows=f(K), q_rows=q[..., :K, :], scales_rows=f(K, N // cq.QBLOCK),
        base_rows=f(K, N), q1=q.reshape(lead + (-1,))[..., :N],
        scales1=f(N // cq.QBLOCK))


def kernel_calls(dev) -> dict:
    """{wrapper name: a no-argument call of it on ``dev``}."""
    def run(fleet):
        return _operands(dev, (2,) if fleet else ())

    def agg(fn, fleet=False):
        def call():
            o = run(fleet)
            return fn(o['cache'], o['trained'], o['global_prev'], o['picked'],
                      o['undrafted'], o['deprecated'], o['weights'])
        return call

    def q8(fn, fleet=False):
        def call():
            o = run(fleet)
            return fn(o['q'], o['scales'], o['base'], o['cache'],
                      o['global_prev'], o['picked'], o['undrafted'],
                      o['deprecated'], o['completed'], o['weights'])
        return call

    def rows_agg(fn, fleet=False):
        def call():
            o = run(fleet)
            return fn(o['buf'], o['trained_rows'], o['global_prev'], o['agg'],
                      o['rows'], o['roles'], o['w_rows'])
        return call

    def q8_rows(fn, fleet=False):
        def call():
            o = run(fleet)
            return fn(o['q_rows'], o['scales_rows'], o['base_rows'], o['buf'],
                      o['global_prev'], o['agg'], o['rows'], o['roles'],
                      o['w_rows'])
        return call

    def tier(fn, fleet=False):
        def call():
            o = run(fleet)
            return fn(o['buf'], o['trained_rows'], o['global_prev'], o['agg'],
                      o['rows'], o['rows'], o['roles'], o['w_rows'])
        return call

    def q8_tier(fn, fleet=False):
        def call():
            o = run(fleet)
            return fn(o['q_rows'], o['scales_rows'], o['base_rows'], o['buf'],
                      o['global_prev'], o['agg'], o['rows'], o['rows'],
                      o['roles'], o['w_rows'])
        return call

    def one(fn, *names, fleet=False, **kw):
        def call():
            o = run(fleet)
            return fn(*(o[n] for n in names), **kw)
        return call

    def attention():
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn((1, 16, 2, 16), generator=g).to(dev)
                   .requires_grad_() for _ in range(3))
        return swa_attention(q, k, v, window=4)

    return {
        'safa_aggregate': agg(sa.safa_aggregate),
        'safa_aggregate_fleet': agg(sa.safa_aggregate_fleet, True),
        'safa_aggregate_packed': agg(sa.safa_aggregate_packed),
        'safa_aggregate_packed_fleet': agg(sa.safa_aggregate_packed_fleet,
                                           True),
        'safa_aggregate_packed_q8': q8(sa.safa_aggregate_packed_q8),
        'safa_aggregate_packed_q8_fleet': q8(
            sa.safa_aggregate_packed_q8_fleet, True),
        'safa_aggregate_packed_rows': rows_agg(sa.safa_aggregate_packed_rows),
        'safa_aggregate_packed_rows_fleet': rows_agg(
            sa.safa_aggregate_packed_rows_fleet, True),
        'safa_aggregate_packed_q8_rows': q8_rows(
            sa.safa_aggregate_packed_q8_rows),
        'safa_aggregate_packed_q8_rows_fleet': q8_rows(
            sa.safa_aggregate_packed_q8_rows_fleet, True),
        'safa_aggregate_packed_tier_rows': tier(
            sa.safa_aggregate_packed_tier_rows),
        'safa_aggregate_packed_tier_rows_fleet': tier(
            sa.safa_aggregate_packed_tier_rows_fleet, True),
        'safa_aggregate_packed_q8_tier_rows': q8_tier(
            sa.safa_aggregate_packed_q8_tier_rows),
        'safa_aggregate_packed_q8_tier_rows_fleet': q8_tier(
            sa.safa_aggregate_packed_q8_tier_rows_fleet, True),
        'weighted_merge_packed': one(wm.weighted_merge_packed, 'trained',
                                     'global_prev', 'weights'),
        'weighted_merge_packed_fleet': one(wm.weighted_merge_packed_fleet,
                                           'trained', 'global_prev',
                                           'weights', fleet=True),
        'quantize_packed': one(cq.quantize_packed, 'cache'),
        'quantize_packed_fleet': one(cq.quantize_packed_fleet, 'cache',
                                     fleet=True),
        'dequantize_packed': one(cq.dequantize_packed, 'q', 'scales'),
        'dequantize_packed_fleet': one(cq.dequantize_packed_fleet, 'q',
                                       'scales', fleet=True),
        'quantize': one(cq.quantize, 'global_prev'),
        'dequantize': one(cq.dequantize, 'q1', 'scales1', n=N),
        'quantize_rows': one(cq.quantize_rows, 'cache'),
        'dequantize_rows': one(cq.dequantize_rows, 'q', 'scales', n=N),
        'gather_rows': one(rw.gather_rows, 'buf', 'rows'),
        'gather_rows_fleet': one(rw.gather_rows_fleet, 'buf', 'rows',
                                 fleet=True),
        'scatter_rows': one(rw.scatter_rows, 'buf', 'rows', 'trained_rows'),
        'scatter_rows_fleet': one(rw.scatter_rows_fleet, 'buf', 'rows',
                                  'trained_rows', fleet=True),
        'swa_attention': attention,
    }
