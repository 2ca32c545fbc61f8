"""Device resolution and the build of the port's CUDA library.

Every kernel source under ``repro_torch/csrc`` is compiled for Hopper
(``sm_90a``) by ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``.  The build runs at first use (or when
``load_library()`` is called), one ``nvcc`` per source, all started
together.  It goes into ``$REPRO_TORCH_BUILD_DIR`` when that is set, else
into ``build/repro_torch/`` of the checkout the package runs from (an
installed package must name the directory).  The library's file name
carries a hash of the sources, the nvcc flags and ``nvcc --version``, so
a change to any of them builds a new library.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR_ENV = 'REPRO_TORCH_BUILD_DIR'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC')

#: kernel wrapper name -> launches of its CUDA kernel in this process.
#: Bumped by the wrappers where they launch, never by the plain versions.
LAUNCHES = {'safa_aggregate': 0, 'safa_aggregate_packed': 0,
            'quantize_packed': 0, 'safa_aggregate_packed_q8': 0,
            'safa_aggregate_fleet': 0, 'safa_aggregate_packed_fleet': 0,
            'quantize_packed_fleet': 0, 'safa_aggregate_packed_q8_fleet': 0,
            'dequantize_packed': 0, 'dequantize_packed_fleet': 0,
            'weighted_merge_packed': 0, 'weighted_merge_packed_fleet': 0,
            'gather_rows': 0, 'scatter_rows': 0,
            'safa_aggregate_packed_rows': 0,
            'safa_aggregate_packed_q8_rows': 0,
            'gather_rows_fleet': 0, 'scatter_rows_fleet': 0,
            'safa_aggregate_packed_rows_fleet': 0,
            'safa_aggregate_packed_q8_rows_fleet': 0,
            'safa_aggregate_packed_tier_rows': 0,
            'safa_aggregate_packed_q8_tier_rows': 0,
            'safa_aggregate_packed_tier_rows_fleet': 0,
            'safa_aggregate_packed_q8_tier_rows_fleet': 0,
            'quantize': 0, 'dequantize': 0, 'swa_attention': 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
#: C entry points of the library and their argument types (every pointer,
#: and the stream, as c_void_p: a bare int would be cut to 32 bits).
_SIGNATURES = {
    'safa_aggregate_f32': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _P),
    'quantize_packed_f32': (_P, _P, _P, _I, _L, _P),
    'safa_aggregate_q8_f32': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _L, _P),
    'safa_aggregate_fleet_f32': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                 _L, _P),
    'quantize_packed_fleet_f32': (_P, _P, _P, _I, _I, _L, _P),
    'safa_aggregate_q8_fleet_f32': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _I, _I, _L, _P),
    'dequantize_packed_f32': (_P, _P, _P, _I, _L, _P),
    'dequantize_packed_fleet_f32': (_P, _P, _P, _I, _I, _L, _P),
    'weighted_merge_f32': (_P, _P, _P, _P, _I, _L, _P),
    'weighted_merge_fleet_f32': (_P, _P, _P, _P, _I, _I, _L, _P),
    'gather_rows_f32': (_P, _P, _P, _I, _I, _L, _P),
    'scatter_rows_f32': (_P, _P, _P, _I, _I, _L, _P),
    'safa_aggregate_rows_f32': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _L, _P),
    'safa_aggregate_q8_rows_f32': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P, _P, _I, _I, _L, _P),
    'gather_rows_fleet_f32': (_P, _P, _P, _I, _I, _I, _L, _P),
    'gather_rows_grid': (_I, _I, _L, _P),
    'scatter_rows_fleet_f32': (_P, _P, _P, _I, _I, _I, _L, _P),
    'safa_aggregate_rows_fleet_f32': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _L, _P),
    'safa_aggregate_q8_rows_fleet_f32': (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _P, _P, _P, _P, _I, _I, _I, _L, _P),
    'safa_aggregate_tier_rows_f32': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _L, _P),
    'safa_aggregate_q8_tier_rows_f32': (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _P, _P, _I, _I, _L, _P),
    'safa_aggregate_tier_rows_fleet_f32': (_P, _P, _P, _P, _P, _P, _P, _P,
                                           _P, _P, _I, _I, _I, _L, _P),
    'safa_aggregate_q8_tier_rows_fleet_f32': (_P, _P, _P, _P, _P, _P, _P,
                                              _P, _P, _P, _P, _P, _I, _I,
                                              _I, _L, _P),
    'safa_q8_tier_rows_grid': (_I, _L, _P),
    'quantize_f32': (_P, _P, _P, _L, _P),
    'dequantize_f32': (_P, _P, _P, _L, _P),
    'quantize_rows_f32': (_P, _P, _P, _I, _L, _P),
    'dequantize_rows_f32': (_P, _P, _P, _I, _L, _P),
    'swa_attention_f32': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    'swa_attention_bf16': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_device(device='cuda') -> torch.device:
    """The device an entry point runs on.  ``'cuda'`` (the default of every
    entry point) raises when no card is visible: the port never falls
    back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {dev} (want cuda or cpu)')
    return dev


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if cand and (pathlib.Path(cand) / 'bin' / 'nvcc').exists():
            return str(pathlib.Path(cand) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME or put it on PATH); '
                           'the CUDA kernels are built on the machine that '
                           'runs them')
    return found


def build_dir() -> pathlib.Path:
    """Where the library is built: ``$REPRO_TORCH_BUILD_DIR``, else
    ``build/repro_torch/`` beside the ``src/`` the package is imported
    from.  An installed package (not under a checkout's ``src/``) raises
    rather than write into the environment's site-packages."""
    if os.environ.get(BUILD_DIR_ENV):
        return pathlib.Path(os.environ[BUILD_DIR_ENV]).resolve()
    src = CSRC.parents[1]
    if src.name == 'src' and (src.parent / 'pyproject.toml').exists():
        return src.parent / 'build' / 'repro_torch'
    raise RuntimeError(
        f'repro_torch is not imported from a checkout\'s src/ ({src}); set '
        f'{BUILD_DIR_ENV} to the directory its CUDA library is built in')


def library_name(sources, flags, nvcc_version: str) -> str:
    """File name of the library built from ``sources`` with ``flags`` by
    the nvcc that reports ``nvcc_version``: any change to them names
    another file, so a stale library is never loaded."""
    h = hashlib.sha256()
    for s in sources:
        h.update(s.name.encode() + b'\0' + s.read_bytes() + b'\0')
    h.update('\0'.join(flags).encode() + b'\0' + nvcc_version.encode())
    return f'librepro_torch_kernels-{h.hexdigest()[:16]}.so'


def build_library(verbose: bool = False) -> pathlib.Path:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link
    them into the shared library; returns its path.  A fresh library is
    written under a temporary name and renamed, so a concurrent loader
    never sees half a file."""
    sources = sorted(CSRC.glob('*.cu'))
    nvcc = _nvcc()
    version = subprocess.run([nvcc, '--version'], capture_output=True,
                             text=True, check=True).stdout
    out_dir = build_dir()
    lib = out_dir / library_name(sources, NVCC_FLAGS, version)
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [pathlib.Path(tmp) / (s.stem + '.o') for s in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, '-Xptxas', '-v', '-c', str(s), '-o', str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f'nvcc failed on {s.name}:\n{log}')
            if verbose:
                print(f'[nvcc {s.name}]\n{log.strip()}')
        out = pathlib.Path(tmp) / lib.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, '-shared', *map(str, objs),
                               '-o', str(out)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f'nvcc link failed:\n{link.stdout}{link.stderr}')
        os.replace(out, lib)
    return lib


def load_library(verbose: bool = False):
    """The loaded CUDA library, built first if it is missing or stale.
    Returns (library, seconds spent building and loading)."""
    global _lib
    t0 = time.perf_counter()
    if _lib is None:
        lib = ctypes.CDLL(str(build_library(verbose)))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib, time.perf_counter() - t0


def call(name: str, device: torch.device, *args) -> None:
    """Launch C entry point ``name`` on ``device``'s current stream; raises
    on a non-zero ``cudaError_t`` (a refused launch never runs, and a
    later synchronise would not report it)."""
    lib, _ = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: '
                           f'cudaError_t {err}')


def refuse_grad(tensors) -> None:
    """Raise when grad is enabled and an operand requires it: the kernels
    (and their plain versions, which stand in for them on the CPU) have
    no backward, as the JAX package's Pallas kernels have none, so a
    gradient must not stop silently at a kernel's output."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            'a kernel operand requires grad, but the kernels are not '
            'differentiable (the JAX package has no backward for them '
            'either): call them under torch.no_grad() or on detached '
            "tensors, and train the models with attn_impl='flash_jnp'")


def is_cuda(*tensors) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; mixed placements raise, and so does an operand that
    requires grad while grad is enabled (``refuse_grad``).  Every kernel
    wrapper asks this first."""
    refuse_grad(tensors)
    kinds = {t.device.type for t in tensors}
    if kinds == {'cuda'}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError('kernel operands lie on different CUDA devices')
        return True
    if kinds == {'cpu'}:
        return False
    raise ValueError(f'kernel operands on mixed devices: {sorted(kinds)}')


def check_operand(t: torch.Tensor, name: str, dtype, shape,
                  device: torch.device) -> None:
    """Device, dtype, shape and contiguity checks before a pointer crosses
    into C."""
    if t.device != device:
        raise ValueError(f'{name}: expected a tensor on {device}, got one '
                         f'on {t.device}')
    if t.dtype != dtype:
        raise TypeError(f'{name}: expected {dtype}, got {t.dtype}')
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f'{name}: expected shape {tuple(shape)}, '
                         f'got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name}: kernel operands must be contiguous')
