"""Variants of the row gather (kernels 11 and 13, ``csrc/rows.cu``) built
side by side and timed in turns on one card.

Each variant is ``src/repro_torch/csrc/rows.cu`` with some of its
gather's constants changed (or its proxy fence taken out), compiled
alone into a shared library with the package's nvcc flags; ``--parent
DIR`` adds the ``rows.cu`` of another checkout's ``src/`` (for example
a ``git archive`` of the parent commit) as the variant ``parent``.  At
four shapes of the main path (R 1001, K 124; the lag tier's value buffer
of 123 rows read through two distinct rows, K 124; R 101, K 30; a fleet
of S 4, R 1001, K 125; N 342,016 at each) every variant is held bit for
bit against ``torch.index_select`` and then timed twice by CUDA events
over 30 back-to-back launches through ``ctypes``, the variants in turns
(forward, then backward), ``index_select`` twice after them.  The two
"register stores" variants swap in a kernel whose consumer warps store
each stage from registers and release it to the next bulk load, with
and without ``fence.proxy.async`` between their reads and the release;
the one without prints FAIL where a load overwrote bytes not yet read,
and the script then exits 1.  Needs an NVIDIA GPU and nvcc:

    python3 scripts/gather_variants.py [--parent DIR/src] [NAME ...]
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / 'src' / 'repro_torch' / 'csrc' / 'rows.cu'
NVCC = '/usr/local/cuda/bin/nvcc'
FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-Xcompiler', '-fPIC', '-shared')
FENCE = '    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
N = 342_016


def consts(**kw):
    """Replacements that set the gather's constants ``kw`` (name: value)."""
    default = {'kStageBytes': 'int kStageBytes = 16384;',
               'kStages': 'int kStages = 3;',
               'kMaxRun': 'long long kMaxRun = 16384;'}
    return [(default[k], default[k].split('=')[0] + f'= {v};')
            for k, v in kw.items()]


#: The gather with the stores taken out of the bulk-copy engine: one
#: producer thread bulk-loads the ring, 8 consumer warps read each stage
#: into registers, release it on an "empty" mbarrier (as kernel 20's
#: consumers do) and store from registers.  FENCE_READS is what goes
#: between their reads and the release.
REGISTER_STORES = r"""
constexpr int kCons = 256;
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__global__ void __launch_bounds__(kCons + 32)
gather_rows_ring_kernel(const char* __restrict__ buf,
                        const int* __restrict__ rows, char* __restrict__ out,
                        int n_rows, int k, long long row, long long total,
                        long long run) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* stages = smem + kBarBytes;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_u32(full + i), 1);
      mbar_init(smem_u32(empty + i), kCons / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long lo = (long long)blockIdx.x * run;
  const long long hi = min(lo + run, total);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kCons) {
    if (lane != 0) return;
    long long ld = lo;
    for (uint32_t n = 0; ld < hi; ++n) {
      const long long q = ld / row, off = ld - q * row;
      const char* src =
          buf + ((q / k) * n_rows + fix_row(rows[q], n_rows)) * row;
      const long long end = item_end(ld, off, row, hi);
      const uint32_t st = n % kStages, bar = smem_u32(full + st);
      mbar_wait(smem_u32(empty + st), ((n / kStages) & 1) ^ 1);
      mbar_expect_tx(bar, (uint32_t)(end - ld));
      bulk_load(smem_u32(stages + st * kStageBytes), src + off,
                (uint32_t)(end - ld), bar);
      ld = end;
    }
    return;
  }
  long long so = lo;
  for (uint32_t n = 0; so < hi; ++n) {
    const long long end = item_end(so, so % row, row, hi);
    const uint32_t st = n % kStages;
    mbar_wait(smem_u32(full + st), (n / kStages) & 1);
    const float4* stg =
        reinterpret_cast<const float4*>(stages + st * kStageBytes);
    float4* dst = reinterpret_cast<float4*>(out + so);
    const int n16 = (int)((end - so) / 16);
    float4 v[kStageBytes / 16 / kCons];
#pragma unroll
    for (int u = 0; u < kStageBytes / 16 / kCons; ++u) {
      const int i = threadIdx.x + u * kCons;
      if (i < n16) v[u] = stg[i];
    }
    FENCE_READS
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(empty + st));
#pragma unroll
    for (int u = 0; u < kStageBytes / 16 / kCons; ++u) {
      const int i = threadIdx.x + u * kCons;
      if (i < n16) dst[i] = v[u];
    }
    so = end;
  }
}

"""


def register_stores(fence: bool):
    """Replacements that swap the kernel for REGISTER_STORES (persistent,
    6 stages, so that every stage is loaded again many times)."""
    def swap(text):
        i = text.index('__global__ void __launch_bounds__(kThreads)\n'
                       'gather_rows_ring_kernel')
        j = text.index("// The launch's shape")
        body = REGISTER_STORES.replace(
            'FENCE_READS', FENCE.strip() if fence else '')
        return text[i:j], body
    return [swap, ('gather::kThreads,\n', '288,\n'),
            ('gather_rows_ring_kernel, kThreads, kSmem',
             'gather_rows_ring_kernel, 288, kSmem')] + consts(
                 kMaxRun='1LL << 60', kStages=6)


#: name -> replacements in this tree's rows.cu.  A 'persistent' variant
#: gives each block one equal share of the copy, in one wave of blocks
#: (6 x 16 KB: the ring's first form, two blocks an SM)
VARIANTS = {
    'this tree': [],
    'no fence': [(FENCE, '')],
    'run 32 KB': consts(kMaxRun=32768),
    'run 64 KB': consts(kMaxRun=65536),
    'run 16 KB, 6 stages': consts(kStages=6),
    'run 8 KB, 8 KB stages': consts(kMaxRun=8192, kStageBytes=8192),
    'persistent, 6 x 16 KB': consts(kMaxRun='1LL << 60', kStages=6),
    'persistent, 3 x 16 KB': consts(kMaxRun='1LL << 60'),
    'persistent, 12 x 16 KB': consts(kMaxRun='1LL << 60', kStages=12),
    'register stores, fenced release': register_stores(True),
    'register stores, release without a fence': register_stores(False),
}


def build(texts: dict, out: pathlib.Path) -> dict:
    """Compile every variant's source at once; name -> loaded library."""
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = out / f'v{i}.cu'
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [NVCC, *FLAGS, str(cu), '-o', str(out / f'v{i}.so')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for i, (name, p) in enumerate(procs.items()):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f'nvcc failed on {name}:\n{log}')
        lib = ctypes.CDLL(str(out / f'v{i}.so'))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gather_rows_f32.argtypes = [P, P, P, I, I, L, P]
        lib.gather_rows_fleet_f32.argtypes = [P, P, P, I, I, I, L, P]
        libs[name] = lib
    return libs


def shapes(dev):
    """name -> (buf, rows int32) at the main path's shapes, seeded."""
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return {
        'R 1001, K 124': (rand(1001, N),
                          put(np.sort(rng.choice(1000, 124, replace=False)))),
        'tier: R 123, K 124 over 2 rows': (
            rand(123, N), put(rng.choice(np.array([0, 122]), 124))),
        'R 101, K 30': (rand(101, N),
                        put(np.sort(rng.choice(100, 30, replace=False)))),
        'fleet: S 4, R 1001, K 125': (
            rand(4, 1001, N),
            put(np.stack([np.sort(rng.choice(1000, 125, replace=False))
                          for _ in range(4)])))}


def launcher(lib, buf, rows, out, stream):
    if buf.ndim == 3:
        s, r, n = buf.shape
        args = (buf.data_ptr(), rows.data_ptr(), out.data_ptr(), s, r,
                rows.shape[1], n, stream)
        return lambda: lib.gather_rows_fleet_f32(*args)
    r, n = buf.shape
    args = (buf.data_ptr(), rows.data_ptr(), out.data_ptr(), r,
            rows.shape[0], n, stream)
    return lambda: lib.gather_rows_f32(*args)


def timed(fn, warm=5, reps=30) -> float:
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parent', type=pathlib.Path, default=None,
                    help="another checkout's src/, timed as 'parent'")
    ap.add_argument('names', nargs='*', help='variants to build (all)')
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('gather_variants: needs an NVIDIA GPU', file=sys.stderr)
        return 2
    cur = SRC.read_text()
    texts = {}
    for name, pairs in VARIANTS.items():
        if opts.names and name not in opts.names:
            continue
        text = cur
        for pair in pairs:
            a, b = pair(text) if callable(pair) else pair
            if a not in text:
                raise ValueError(f'{name}: {a!r} not in rows.cu')
            text = text.replace(a, b)
        texts[name] = text
    if opts.parent is not None:
        texts['parent'] = (opts.parent / 'repro_torch' / 'csrc' /
                           'rows.cu').read_text()
    dev = torch.device('cuda')
    print(torch.cuda.get_device_name(0))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(texts, pathlib.Path(tmp))
        stream = torch.cuda.current_stream().cuda_stream
        fails = 0
        for label, (buf, rows) in shapes(dev).items():
            s = buf.shape[0] if buf.ndim == 3 else 1
            r = buf.shape[-2]
            flat = (rows.long().reshape(s, -1)
                    + r * torch.arange(s, device=dev)[:, None]).reshape(-1)
            view = buf.reshape(-1, N)
            want = torch.index_select(view, 0, flat).view(*rows.shape, N)
            out = torch.empty_like(want)
            ms = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                fn = launcher(libs[name], buf, rows, out, stream)
                out.zero_()
                err = fn()
                torch.cuda.synchronize()
                if err != 0 or not torch.equal(out, want):
                    print(f'FAIL {name} at {label}: cudaError_t {err} or '
                          f'not index_select\'s bits')
                    fails += 1
                    ms[name].append(float('nan'))
                    continue
                ms[name].append(timed(fn))
            lib_ms = [timed(lambda: torch.index_select(view, 0, flat))
                      for _ in range(2)]
            print(f'{label}: index_select {lib_ms} ms')
            for name, t in sorted(ms.items(), key=lambda kv: np.mean(kv[1])):
                print(f'    {name}: {t} ms')
            del want, out
    return 1 if fails else 0


if __name__ == '__main__':
    sys.exit(main())
