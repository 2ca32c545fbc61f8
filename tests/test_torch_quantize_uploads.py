"""The per-leaf int8 upload reference (``SafaSpec(quantize_uploads=True)``)
of the port against the JAX package's, on the same seeded inputs, and
against the port's own packed int8 wire.

Tolerances:

* ``quantize`` / ``dequantize`` (the plain versions of kernels 5 and 6)
  against the JAX package's Pallas kernels in interpret mode: q equal,
  scales within rtol 1e-6 (the JAX package's division moves some scales
  by one ulp against an IEEE division: 1 of 2450 at n = 313,600), and the
  dequantised vector equal given the same (q, scales), one multiply each;
* the per-leaf round trip of a stacked model equals the packed wire's
  (``ops.wire_roundtrip_packed``) bit for bit: ``wire_spec`` aligns every
  leaf to a 128-value block, so both quantise the same blocks;
* whole quickstart runs (24 rounds) against the reference's per-leaf
  runs: eval losses rtol 1e-4 and ``final_global`` atol 1e-4, the int8
  suites' tolerance (one ulp of an int8 scale moves a weight by ~4e-6);
  records and futility equal;
* inside the port, scan == loop bit for bit, and the per-leaf run with
  ``use_kernel='packed'`` == the ``wire='int8'`` run bit for bit (the
  uploads are the same bits and both servers sum the [m, N] pack
  buffer).  With ``use_kernel=False`` or ``True`` the server sums each
  leaf as its own [m, n_leaf] tensor, and torch's CPU sum over the
  clients axis associates by the inner width (an [m, 13] and an
  [m, 2048] sum of the same rows differ by an ulp), so those runs are
  held to the int8 wire's run within atol 1e-5 (measured: 9.5e-7 after
  24 rounds), not bit for bit; the JAX package's XLA sums both layouts
  alike.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.data import make_regression, partition
from repro.data import tasks as jtasks
from repro.fedsim import EnvSpec as JEnvSpec
from repro.kernels import ops as jops
from repro.kernels.comm_quant import dequantize as j_dequantize
from repro.kernels.comm_quant import quantize as j_quantize
from repro_torch import api as tapi
from repro_torch.core import federation as tfed
from repro_torch.data import tasks as ttasks
from repro_torch.fedsim import EnvSpec as TEnvSpec
from repro_torch.kernels import backend
from repro_torch.kernels import ops as tops
from repro_torch.kernels.comm_quant import dequantize, quantize

QUICKSTART = dict(m=5, crash_prob=0.3, dataset_size=506, batch_size=5,
                  epochs=3, t_lim=830.0, seed=3)
ROUNDS, EVAL_EVERY = 24, 6
SAFA = dict(fraction=0.5, lag_tolerance=5)
SIZES = [1, 13, 127, 128, 129, 2047, 2048, 2049, 313_600]
KERNELS = [False, True, 'packed']
KERNEL_IDS = ['plain', 'per_leaf', 'packed']


@pytest.fixture(autouse=True)
def _zero_launches():
    backend.reset_launches()
    yield
    assert all(v == 0 for v in backend.LAUNCHES.values()), \
        'a wrapper launched a kernel on CPU tensors'


def _np(a):
    return np.array(a)


@pytest.mark.parametrize('n', SIZES)
def test_quantize_matches_reference(n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32) * 3
    x[:min(n, 128) // 2] = 0.0           # a zero (or half-zero) first block
    jq, js = j_quantize(jnp.asarray(x))
    q, s = quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and q.shape == (n,)
    assert s.dtype == torch.float32 and s.shape == (-(-n // 128),)
    np.testing.assert_array_equal(q.numpy(), _np(jq))
    np.testing.assert_allclose(s.numpy(), _np(js), rtol=1e-6, atol=0)
    got = dequantize(torch.from_numpy(_np(jq)), torch.from_numpy(_np(js)),
                     n=n)
    np.testing.assert_array_equal(got.numpy(),
                                  _np(j_dequantize(jq, js, n=n)))


def test_wrappers_refuse_bad_operands():
    with pytest.raises(ValueError, match='flat'):
        quantize(torch.zeros(2, 3))
    with pytest.raises(ValueError, match='flat'):
        quantize(torch.zeros(0))
    q, s = quantize(torch.ones(300))
    with pytest.raises(ValueError, match='scales'):
        dequantize(q, s[:2], n=300)
    with pytest.raises(ValueError, match='300 values'):
        dequantize(q[:299], s, n=300)


@pytest.fixture(scope='module')
def cnn_init():
    """Task 2's CNN init (the port's, seeded), as both packages hold it."""
    t = ttasks._cnn_init(torch.Generator().manual_seed(0))
    return {k: jnp.asarray(v.numpy()) for k, v in t.items()}, t


def test_quantize_tree_matches_reference(cnn_init):
    j, t = cnn_init
    jq = jops.quantize_tree(j)
    tq = tops.quantize_tree(t)
    assert list(tq) == sorted(j)
    for k, (q, s) in tq.items():
        np.testing.assert_array_equal(q.numpy(), _np(jq[k][0]), err_msg=k)
        np.testing.assert_allclose(s.numpy(), _np(jq[k][1]), rtol=1e-6,
                                   atol=0, err_msg=k)
    back = tops.dequantize_tree(
        {k: (torch.from_numpy(_np(q)), torch.from_numpy(_np(s)))
         for k, (q, s) in jq.items()}, t)
    want = jops.dequantize_tree(jq, j)
    for k, v in back.items():
        assert v.shape == t[k].shape and v.dtype == t[k].dtype
        np.testing.assert_array_equal(v.numpy(), _np(want[k]), err_msg=k)


def test_per_leaf_roundtrip_equals_packed_wire(cnn_init):
    _, t = cnn_init
    gen = torch.Generator().manual_seed(0)
    stacked = {k: v + 0.05 * torch.randn((3,) + tuple(v.shape),
                                         generator=gen)
               for k, v in t.items()}
    per_leaf = tfed._quantized_train_fn(lambda s: s)(stacked)
    packed = tops.wire_roundtrip_packed(stacked, like=t)
    for k, v in packed.items():
        assert torch.equal(per_leaf[k], v), k


# -- whole runs ---------------------------------------------------------------

@pytest.fixture(scope='module')
def quickstart():
    x, y = make_regression()
    env = JEnvSpec(**QUICKSTART).build()
    data = partition(x, y, env.partition_sizes, batch_size=5, seed=1)
    jt = jtasks.regression_task(data, lr=1e-3, epochs=3)
    tt = ttasks.regression_task(data, lr=1e-3, epochs=3, device='cpu')
    init = {k: np.array(v) for k, v in
            jt.init_global(jax.random.PRNGKey(0)).items()}
    return jt, tt, init


@pytest.fixture(scope='module')
def runs(quickstart):
    """Memoised runs: runs(pkg, quantize_uploads, **exec) -> History."""
    jt, tt, init = quickstart
    memo = {}

    def run(pkg, qu, **ex):
        key = (pkg, qu, tuple(sorted(ex.items())))
        if key not in memo:
            if pkg == 'jax':
                exp = japi.Experiment(
                    jt, JEnvSpec(**QUICKSTART).build(),
                    japi.SafaSpec(quantize_uploads=qu, **SAFA),
                    japi.ExecSpec(eval_every=EVAL_EVERY, **ex),
                    rounds=ROUNDS)
            else:
                exp = tapi.Experiment(
                    tt, TEnvSpec(**QUICKSTART).build(),
                    tapi.SafaSpec(quantize_uploads=qu, **SAFA),
                    tapi.ExecSpec(eval_every=EVAL_EVERY, **ex),
                    rounds=ROUNDS, device='cpu', init_params=init)
            memo[key] = exp.compile().run()
        return memo[key]
    return run


def _timing(records):
    return [dataclasses.asdict(dataclasses.replace(r, eval=None))
            for r in records]


def _losses(hist):
    return np.array([e['loss'] for _, e in hist.evals()])


@pytest.mark.parametrize('engine', ['scan', 'loop'])
@pytest.mark.parametrize('use_kernel', KERNELS, ids=KERNEL_IDS)
def test_run_matches_reference(runs, use_kernel, engine):
    port = runs('torch', True, use_kernel=use_kernel, engine=engine)
    ref = runs('jax', True, use_kernel=use_kernel)
    assert [r for r, _ in port.evals()] == [6, 12, 18, 24]
    np.testing.assert_allclose(_losses(port), _losses(ref), rtol=1e-4)
    for k, v in ref.final_global.items():
        np.testing.assert_allclose(port.final_global[k].numpy(),
                                   np.asarray(v), rtol=0, atol=1e-4,
                                   err_msg=k)
    assert _timing(port.records) == _timing(ref.records)
    assert port.futility == ref.futility


@pytest.mark.parametrize('use_kernel', KERNELS, ids=KERNEL_IDS)
def test_scan_equals_loop_bitwise(runs, use_kernel):
    scan = runs('torch', True, use_kernel=use_kernel)
    loop = runs('torch', True, use_kernel=use_kernel, engine='loop')
    assert scan.evals() == loop.evals()
    for k, v in scan.final_global.items():
        assert torch.equal(v, loop.final_global[k]), k


def test_per_leaf_equals_int8_wire_bitwise(runs):
    """The port's form of the JAX package's
    ``test_bit_identical_to_per_leaf_reference``: the packed server sums
    the same uploads in the same layout as the int8 wire's."""
    wire = runs('torch', False, wire='int8')
    ref = runs('torch', True, use_kernel='packed')
    assert ref.evals() == wire.evals()
    for k, v in wire.final_global.items():
        assert torch.equal(ref.final_global[k], v), k


@pytest.mark.parametrize('use_kernel', [False, True],
                         ids=['plain', 'per_leaf'])
def test_per_leaf_tracks_int8_wire(runs, use_kernel):
    """The leaf-wise servers sum in another order on the CPU (module
    docstring): within atol 1e-5 of the int8 wire's run, the same
    uploads."""
    wire = runs('torch', False, wire='int8')
    ref = runs('torch', True, use_kernel=use_kernel)
    np.testing.assert_allclose(_losses(ref), _losses(wire), rtol=1e-6)
    for k, v in wire.final_global.items():
        torch.testing.assert_close(ref.final_global[k], v, rtol=0,
                                   atol=1e-5)


def test_deprecated_shim_runs_the_reference(quickstart, runs):
    _, tt, init = quickstart
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        shim = tfed.run_safa(tt, TEnvSpec(**QUICKSTART).build(),
                             rounds=ROUNDS, eval_every=EVAL_EVERY,
                             quantize_uploads=True, use_kernel='packed',
                             device='cpu', **SAFA)
    ref = runs('torch', True, use_kernel='packed')
    assert _timing(shim.records) == _timing(ref.records)
    assert shim.futility == ref.futility


# -- refusals -----------------------------------------------------------------

def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize('ex', [dict(wire='int8'),
                                dict(schedule='sparse'),
                                dict(schedule='sparse_delta'),
                                dict(schedule='sparse_tier',
                                     use_kernel='packed')],
                         ids=['wire', 'sparse', 'sparse_delta', 'tier'])
def test_refusals_match_reference(ex):
    got = _message(lambda: tapi.check_compat(
        tapi.SafaSpec(quantize_uploads=True), tapi.ExecSpec(**ex)))
    want = _message(lambda: japi.check_compat(
        japi.SafaSpec(quantize_uploads=True), japi.ExecSpec(**ex)))
    assert got == want


@pytest.mark.parametrize('engine', ['fleet', 'sequential'])
def test_sweep_refusal_matches_reference(quickstart, engine):
    jt, tt, _ = quickstart

    def sweep(api, task, spec_cls, device):
        exp = api.Experiment(task, None,
                             api.SafaSpec(quantize_uploads=True, **SAFA),
                             api.ExecSpec(engine=engine), rounds=2,
                             **device)
        members = [api.SweepMember(env=spec_cls(**QUICKSTART), seed=s)
                   for s in range(2)]
        return lambda: exp.compile().run_sweep(members)

    got = _message(sweep(tapi, tt, TEnvSpec, dict(device='cpu')))
    want = _message(sweep(japi, jt, JEnvSpec, {}))
    assert got == want == (
        'quantize_uploads is the single-run per-leaf reference knob; '
        "sweeps take the packed wire instead (wire='int8')")
