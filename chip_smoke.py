#!/usr/bin/env python3
"""Drive the PyTorch port's SAFA paths on one NVIDIA GPU and hold each of
its CUDA kernels against its plain PyTorch version.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build   — nvcc compiles src/repro_torch/csrc/*.cu (one process per
             source, in parallel) into build/repro_torch/.
2. kernels — every kernel of the paths at their shapes (m = 100 clients,
             N = 342,016: the Task 2 CNN's pack width; the fleet kernels at
             S = 4 members), on seeded inputs, against its plain version on
             the card, and each fleet kernel bit for bit against the
             single-run kernel on every member's slices; times from CUDA
             events over warm launches, beside the least time the card
             could take: the bytes these inputs' masks need (Eq. 6-8
             selects whole client rows; the weighted merge reads only
             rows of non-zero weight) over the memory rate, and, where
             one PyTorch call computes the same function (the weighted
             merge: ``torch.addmv``, a fleet's ``torch.bmm``), its time.
             The sparse schedules' kernels 11, 12, 15 and 16 run at the
             quota-bounded shape (R = 1001 buffer rows, K = 124 slots) with
             the rows and roles of round 2 of the m = 1000 schedule:
             gather, scatter (and a case with a duplicate row and two
             rows outside [0, R), which go to the scratch row) and the
             c2 and local rows bit for bit, new_global and new_agg within
             rtol 1e-5 /
             atol 1e-6, every kernel the same bits on two launches; the
             gather and scatter beside ``torch.index_select`` and
             ``index_copy_``.  Their fleet forms (kernels 13, 14, 17
             and 18) run at S = 4 members of that shape, each member the
             round-2 rows and roles of its own m = 1000 schedule (env
             seeds 0-3), padded to the fleet's widest K: against their
             plain versions and, member by member, bit for bit against
             the single-run kernels; the gather and scatter beside
             ``index_select``/``index_copy_`` on the [S * R, N] view.
             The gather (11, 13) is also held bit for bit and timed
             twice at every shape the main path gives it (m = 100 SAFA
             and FedAvg sparse rounds, m = 1000, the tier's value buffer
             at m = 1000 and 10,000, the S = 4 fleet), ``index_select``
             beside each time, each launch's device time from
             ``torch.profiler`` beside the CUDA events, with its grid.
             The lag tier's kernels 19 and 20 run on the slot maps of
             the m = 1000 quota-bounded tier schedule of two rounds
             (round 2: K = 124, every c2 aimed at the scratch row of a
             buffer of capacity + 1 = 123 rows; round 1: 121 rows written
             in place, three sentinel slots), their S-axis forms on the
             four-member tier fleet's rounds (env seeds 0-3, sentinel
             padding to K = 125): the whole buffer, scratch row included,
             bit for bit the plain version's, new_global and new_agg
             within 5e-7, every member of an S-axis launch bit for bit
             its single launch, timed on both rounds against the bytes
             its slot maps and roles need (no PyTorch call computes
             either; the records are round 2's).  Kernel 20 and its
             S-axis form are then launched 200 times back to back at each
             of the tier shapes (m = 1000 rounds 1 and 2, the fleet's
             rounds 1 and 2, m = 10,000 rounds 1 and 2), every launch's
             buffer bit for bit the plain version's and its sums the
             first launch's: the stress check of the ring's stage release.
             The per-leaf reference's kernels 5 and 6 (``quantize``,
             ``dequantize``) run on every row view of seeded [100, n]
             stacks at the CNN's eight leaf sizes (10 to 313,600 values),
             and through their rows entries (``quantize_rows``,
             ``dequantize_rows``: one launch a row from one C call) on
             each whole stack, bit for bit against their plain versions
             and each other; timed at n = 313,600 and n = 10 (a
             rows-entry launch beside a flat call) against the bytes a
             launch moves, with their device time a launch at both n
             from ``torch.profiler`` windows over one rows-entry call
             (100 launches) of each and, as a control, the flat entry on
             the same 100 rows and on one row 100 times.
3. main    — the paper's Task 2 CNN at full width (m = 100, 24 batches of
             40, 5 epochs) through ``Experiment(...).compile().run()``,
             with ``use_kernel='packed'`` and with ``wire='int8'``; each
             run must launch its kernels once per round, and its eval loss
             must be finite and below the initial model's.  A third run
             with the plain aggregation (``use_kernel=False``) is the
             reference the packed run's model is held to.
3a. quantize_uploads — the per-leaf int8 reference
             (``SafaSpec(quantize_uploads=True)``) on the same task at
             full width, 3 rounds, deterministic cuDNN, evaluated every
             round: with ``use_kernel='packed'`` and plain, beside the
             ``wire='int8'`` run.  Each per-leaf run launches
             ``quantize`` and ``dequantize`` rounds x 100 clients x 8
             leaves times (and the packed run kernel 1 once a round); the
             packed run must equal the int8 wire's bit for bit at every
             eval and in its final model, and plain agree with packed
             within one quantisation step of the largest weight (max |w|
             / 127: the two sum in another order, and an int8 rounding
             edge turns that into a step); every eval loss must fall.
             Each per-leaf run calls ``quantize_rows`` and
             ``dequantize_rows`` once a leaf a round (the host calls;
             each launches kernel 5 or 6 once per client row).  Each run
             prints its per-round train, round-trip and server-step
             seconds.
4. fleet   — a 4-member sweep of the same task at full width through
             ``Experiment(...).compile().run_sweep(members)`` (crash rates
             0.1 / 0.3 / 0.5 / 0.7, seeds 0-3), in the same three runs:
             each must launch its fleet kernels once per round for the
             whole fleet and no single-run kernel, and lower every
             member's eval loss; packed and plain agree per member.
5. baselines — the paper's baselines on the same task at full width, 2
             rounds each: FedAvg and FedCS on the int8 wire (each round
             launches ``quantize_packed`` and ``dequantize_packed`` once),
             FedAvg f32, fully-local and FedAsync (no kernel), and a
             4-member FedAvg int8 crash-rate sweep (the two fleet kernels
             once per round).  Every run's eval loss must fall below its
             initial model's, and FedAvg int8 and f32 must agree within
             what the int8 wire's rounding allows.
6. weighted — the staleness-adaptive family on the same task at full
             width, crash probability 0.3, 2 rounds each: SEAFL with
             ``use_kernel='packed'`` (kernel 10 once per round), on the
             int8 wire with ``'packed'`` (kernels 2, 4 and 10 once per
             round) and plain, CSAFL with 2 clusters ``'packed'``, and a
             4-member mixed-scheme sweep (SEAFL, SEAFL with the loss term,
             CSAFL, the folded FedAsync; crash rates 0.1 / 0.3 / 0.5 / 0.7)
             with ``'packed'`` (kernel 10's fleet form once per round) and
             plain.  Every eval loss must fall below the initial model's,
             packed and plain agree within 1e-5 per member, and the folded
             FedAsync agrees with the sequential FedAsync engine within
             rtol 2e-5: elementwise at one server step on the same
             uploads, and over a 2-round run on the member's env and init
             against the model's largest weight (and in its eval loss).
             The phase trains with deterministic cuDNN: by default the
             convolutions' weight gradients vary from run to run by more
             than these tolerances.
7. sparse  — the sparse schedules on the same task at full width, 2
             rounds each, with deterministic cuDNN: on the paper's
             environment (m = 100) SAFA ``sparse`` packed and int8,
             ``sparse_delta`` packed, packed int8 and plain, their dense
             references, FedAvg ``sparse``, FedAvg ``sparse_delta`` int8,
             FedCS ``sparse_delta`` and their dense references; on the
             quota-bounded environment (m = 1000, the Task 2 data) SAFA
             dense and ``sparse_delta`` packed, f32 and int8.  Each run
             must launch its kernels as
             often per round as its cell says (``sparse_delta`` packed:
             ``gather_rows`` once, ``safa_aggregate_packed_rows`` once,
             ``scatter_rows`` twice; on int8 also ``quantize_packed``, and
             the q8 rows kernel instead), every eval loss must fall, sparse
             against dense and packed against plain agree within 1e-5 on
             f32 after one round (the compared runs are repeated for one
             round) and after two (FedCS ``sparse_delta``, which carries
             the global alone, within 1e-4 after two: its second round
             trains from the first round's rounding, and a control prints
             how far one round of training carries it); an int8 run
             agrees with the int8 dense run within 1e-4 after one round,
             and within one quantisation step of the largest weight
             (max |w| / 127) after two (an int8 rounding edge turns the
             aggregation's summation order into a whole step).  Each run
             prints its K, its train and server-step seconds per round and
             its peak device memory.
8. sparse sweeps — ``run_sweep`` on the sparse schedules, the same task
             at full width, 2 rounds, deterministic cuDNN, every member's
             global kept after each round.  On the paper's environment
             (the fleet phase's four members): SAFA ``sparse_delta``
             packed, f32 and int8 (a fleet round: ``gather_rows_fleet``
             once, ``safa_aggregate_packed_rows_fleet`` or, after
             ``quantize_packed_fleet``, the q8 form once,
             ``scatter_rows_fleet`` twice), SAFA ``sparse`` packed,
             FedAvg ``sparse_delta`` int8 and FedCS ``sparse``, each on
             the fleet and the sequential engine, and their dense fleets.
             Each fleet is held to its sequential run and to its dense
             fleet: f32 within 1e-5 after one round and after two
             (FedCS within 1e-4 after two, as the sparse phase holds its
             stateless pair), int8 within 1e-4 after one round and one
             quantisation step after two.  On the quota-bounded
             environment (four members, env seeds 0-3, m = 1000): SAFA
             ``sparse_delta`` packed, f32 and int8, fleet against
             sequential (a dense fleet would not fit on the card).  Each
             run prints its members' K, seconds per fleet round (or
             member-round) and its peak device memory.
9. tier    — the lag tier (``schedule='sparse_tier'``) on the same task
             at full width, 2 rounds, deterministic cuDNN, on the
             quota-bounded environment: at m = 1000 ``'sparse_tier'``
             packed (a round: ``gather_rows`` and the tier-rows kernel
             once each; int8: ``quantize_packed`` and the int8 form),
             packed int8 and plain, against ``'sparse_delta'`` packed
             (f32 within 1e-5 after one round and after two, int8 as the
             sparse phase holds it); a 4-member tier sweep (env seeds
             0-3) packed, f32 and int8, on both engines, fleet -
             sequential printed per round and held to 0; a packed run at
             m = 10,000.  Each run prints its K, tier capacity, per-round
             train and server-step seconds, launches and peak device
             memory, beside ``'sparse_delta'`` packed at m = 1000.
10. attention — kernel 21 (``swa_attention``, ``csrc/swa_attention.cu``)
             against its plain version at h2o-danube-3-4b's bulk-prefill
             shape (B 1, S 8192, 32 heads over 8 KV heads, head_dim 120,
             window 4096) and at odd shapes (ragged S, one KV head, D 8
             to 256, no window), f32 within 2e-5 and bf16 within 3e-2
             and elementwise within ``BF16_RTOL`` (2e-2) of the plain
             output plus its spread (the scale of P's bf16 rounding);
             timed at the prefill shape in bf16 beside the plain version
             and ``scaled_dot_product_attention`` with a band mask (its
             backend printed), against its bound: the band's
             4 D flops a (query, key) pair at the bf16 tensor-core rate.
             Timed only, at ``INPUT_SHAPES['prefill_32k']``'s length (B 1,
             S 32,768, bf16) beside SDPA: no plain version fits there.
             Also in bf16 at the families' prefill shapes (no window:
             llama4-scout's 40 heads over 8 KV heads of 128 and
             zamba2-1.2b's 32 over 32 of 64 at S 8192, internvl2-26b's
             48 over 8 of 128 at S 8448 = 256 patches + 8192 tokens,
             whisper-medium's decoder's 16 over 16 of 64 at S 8192),
             held to the plain version
             with the same gates and timed beside SDPA (``is_causal``)
             against the same bound; and the f32 entry timed at the
             prefill shape beside SDPA in f32, against its bound at the
             f32 CUDA-core rate.
11. serve  — h2o-danube-3-4b at full width and depth (3,961,839,360
             parameters, bf16, random init on the card): ``prefill_step``
             on B 1 x S 8192 tokens with ``attn_impl='pallas'`` must
             launch kernel 21 once per layer and give the ``'flash_jnp'``
             path's next tokens, its logits within ``PREFILL_GAP``; the
             teacher-forced ``Model.prefill`` within ``TEACHER_TOL`` of
             ``forward_logits`` on 64 tokens; greedy decode through
             ``serve_step``; ``serve.run`` at the JAX CLI's defaults (4 x
             32 prompt tokens, 16 generated) must give that decode's
             tokens.  Prints seconds per prefill and its attention share,
             decode tokens/s, peak device memory and a profile of one
             prefill and one decode step.  bf16 products reduce in f32.
12. families — the MoE, SSM, hybrid, VLM and audio families at full
             width, one after the other, random init on the card:
             llama4-scout-17b-a16e (8 of 48 layers, 19,687,756,800
             parameters), llama4-maverick-400b-a17b (one super-block, a
             dense and a 128-expert MoE layer: 18,555,233,280),
             mamba2-130m (24 layers), zamba2-1.2b (38 layers, 6
             applications of its shared attention block), internvl2-26b
             (48 layers, 19,900,471,296) and whisper-medium (24 encoder
             and 24 decoder layers, 812,734,464); only the MoE models'
             depth is cut.  Each as the serve phase: ``prefill_step`` on
             B 1 x S 8192 (internvl2-26b: plus 256 seeded patch
             embeddings, whisper-medium: 1500 seeded frame embeddings)
             on both ``attn_impl``s where it has attention (kernel 21
             once per causal attention application; the published
             capacity 1.25, its
             ``dropped_frac`` and ``load_balance_loss`` printed), the
             two ``attn_impl``s' logits at the no-drop capacity
             ``capacity_factor = n_experts`` (an MoE model's on the
             first ``NODROP_S`` tokens) within ``PREFILL_GAP`` at the
             positions whose expert routes agree, the others counted
             within ``ROUTE_FLIPS``, the teacher-forced ``Model.prefill``
             on 64 tokens within ``TEACHER_TOL`` at that capacity (route
             flips within ``TEACHER_FLIPS``; whisper's cross caches filled
             from the encoder first; not for internvl2-26b, whose
             forward always prepends patches and whose decode has none),
             greedy decode through ``serve_step`` at B 4 (whisper against
             zero cross caches, as the JAX CLI serves it), and
             ``serve.run`` at the JAX CLI's defaults for mamba2-130m,
             zamba2-1.2b and whisper-medium, equal to that decode.  Prints
             init and peak device memory, prefill tokens/s, kernel 21's
             share, decode ms a step and tokens/s, and profiles of one
             prefill and one decode step.

13. train  — federated LLM training (silo-mode SAFA) on the card, random
             init, bf16, no kernel on the path (every launch count must
             stay 0): qwen3-1.7b at full width and depth (28 layers,
             2,032,264,192 parameters) through ``train.run(...,
             full_size=True)`` at the JAX CLI's defaults (4 clients,
             fraction 0.5, tau 5, crash 0.2, batch 4, seq 64, 2 local
             steps, lr 0.05), rounds cut to 3; one ``SiloSetup.train_step``
             round at ``INPUT_SHAPES['train_4k']``'s length S 4096, its
             global batch cut from 256 to 4 (one sequence a client), one
             local step, remat on; mamba2-130m (24 layers) through
             ``train.run`` at the same defaults.  Each prints seconds a
             round (local train, server step), trained tokens/s and peak
             device memory; profiles give the busy share of a round and
             launches a client step.  Checks: every loss finite; 8 SGD
             steps on one batch lower its loss; one client batch's bf16
             loss and gradients against an f32 recompute on the card
             (``F32_LOSS_GAP``, ``F32_GRAD_COS``); at 4 of 28 layers the
             in-place ``train_step`` bit for bit the out-of-place
             ``protocol.safa_round`` with per-client SGD (global, local,
             cache); the peak under the card's memory.  ``train.run``
             saves its final global model (``ckpt=``, a temporary
             directory): phase 15's check (d) runs there.
14. dryrun — the dry run (``python -m repro_torch.launch.dryrun --all``,
             and with ``--multi-pod``), started in two host processes
             beside phase 2 and read here: every (architecture, input
             shape) cell's step traced on the ``meta`` device, on the
             16 x 16 and the 2 x 16 x 16 production mesh; both must exit
             0 with a row for each of the 33 cells.  One line a cell:
             trace seconds, the arguments' bytes whole and per chip,
             ``fits_one_card`` (the arguments alone within 80 GB) beside
             this card's memory, the roofline terms.  The dry run's
             parameter bytes (leaves) of every model phases 11-13 build,
             and the qwen3-1.7b silo state at C = 4 (9 copies), must equal
             ``memory_allocated`` measured around that init (with
             expandable segments on, so blocks are split to their
             request) within 512 B a leaf.  The serve phase's prefill
             and the train phase's S 64 rounds are printed as shares of
             their one-card rooflines.
15. checkpoint — checkpoint and resume, with deterministic cuDNN, on
             Task 2's CNN at full width: (a) a SAFA run (int8 wire,
             ``use_kernel='packed'``, 2 rounds, evaluated and saved every
             round), (b) a 2-member fleet sweep of it, (c) an m = 1000
             ``'sparse_tier'`` packed int8 run; each uninterrupted, then
             ``checkpoint=p, max_segments=1`` and ``checkpoint=p`` on a
             fresh Experiment: the resumed evals and final models equal
             the uninterrupted ones bit for bit, and each call launches
             its kernels for one round only.  (d), in the train phase:
             qwen3-1.7b's ``train.run(..., ckpt=)`` file (about 4.06 GB)
             served by ``serve.run(..., full_size=True, ckpt=)`` at the
             CLI's serving defaults; every restored leaf equals the
             trained global bit for bit (bf16 as int16); prints the
             file's bytes, the free space beside it and the seconds to
             save and to restore, then deletes it.  (e) one
             ``EnvSpec(comm='wire')`` run of one round; prints the
             uplink and downlink MB on both wires.

16. analysis — the port's contract checker (``repro_torch.analysis``)
             on the card, right after the kernel phases:
             ``run_all(device='cuda')`` over the 84 admitted cells of the
             registry (each run for two segments of two rounds at the
             JAX package's tiny shapes, every kernel on the card, each
             segment under ``torch.cuda.set_sync_debug_mode('error')``),
             the schedule pass and the conventions pass; prints the count
             of findings of each rule, and every failed finding fails the
             script.

The line before the last is a JSON object of kernel records; the last
line is ``{"ok": true, "device": {...}}``.  Without a visible card, or
run from a directory that holds no ``src/repro_torch``, the script prints
no result and exits non-zero.

    python3 chip_smoke.py --tier-kernels [--src DIR]

runs only the build and the lag tier's kernel phase (kernels 19 and 20,
timed on both rounds), with the package under DIR (a checkout's
``src/``; default this script's): two versions of the kernels compared
in turns on one card, with the same phase timing both.  It exits 0 when
every check passes and prints no ``ok`` line.  ``--rows-kernels`` runs
the rows kernel phases (kernels 11-18; the gather timed at every shape
the main path gives it) the same way, and ``--sparse-runs`` the sparse,
sparse-sweep and tier phases, whose runs each print the sha256 of their
final model: two trees whose lines agree ended every run on the same
bits.

    python3 chip_smoke.py --train

runs only the build and the train phase (13), with the same exit
contract; ``--checkpoint`` only the build and the checkpoint phase (15;
its check (d) runs with the train phase); ``--analysis`` only the build
and the analysis phase (16).
"""
import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

ROUNDS = 3              # rounds per main-path run (never cut m, widths, batch
                        # or epochs; cut this if the time limit forces it)
FLEET_ROUNDS = 2        # rounds per fleet run: a fleet round trains 4x the
                        # clients of a single-run round
M = 100                 # clients on the main path (PAPER_TASKS['task2_cnn'])
S = 4                   # fleet members
FLEET_CRASH = (0.1, 0.3, 0.5, 0.7)   # member s's crash probability
BASE_ROUNDS = 2         # rounds per baseline run and baseline sweep
WEIGHTED_ROUNDS = 2     # rounds per weighted-merge run and sweep
SPARSE_ROUNDS = 2       # rounds per sparse-phase run
SCALE_M, QUOTA = 1000, 50   # the quota-bounded environment (rows, sparse)
#: the weighted sweep's members: (protocol-field overrides, crash rate)
MIXED = (({}, 0.1), ({'use_loss': True}, 0.3),
         ({'scheme': 'csafl', 'clusters': 2}, 0.5),
         ({'scheme': 'fedasync'}, 0.7))
WARM, TIMED = 5, 30     # kernel launches before and inside the timed window
#: the H100 SXM's published device-memory rate (bytes/s) and float32
#: CUDA-core rate (FLOP/s), at its 700 W limit; the card's name and power
#: limit are printed beside every number
PEAK_BYTES, PEAK_FLOPS = 3.35e12, 67e12
#: its dense bf16 tensor-core rate (FLOP/s): attention's bound on bf16 inputs
PEAK_BF16_FLOPS = 989e12
ARCH = 'h2o-danube-3-4b'   # the one configuration with a sliding window
#: the bulk prefill's shape, cut from INPUT_SHAPES['prefill_32k'] (B 32,
#: S 32,768, whose bf16 logits alone would take 67 GB)
PREFILL_B, PREFILL_S = 1, 8192
SERVE = dict(batch=4, prompt_len=32, gen=16)   # the JAX CLI's defaults
TEACHER_LEN = 64        # the teacher-forced prefill's prompt
#: bounds at full width in bf16 (24 layers of bf16 rounding, in another
#: order on each side): the largest |logit| gap of the bulk prefill's
#: kernel path against 'flash_jnp', and of the teacher-forced decode-step
#: prefill against forward_logits.  The families phase holds its four
#: models to the same two (on an H100 before the final run: up to 0.156
#: and 0.199, zamba2's 38 SSM layers the largest teacher-forced gap)
PREFILL_GAP, TEACHER_TOL = 0.25, 0.25
#: kernel 21's bf16 gate, elementwise: |out - plain| <= BF16_RTOL (|plain|
#: + spread) + BF16_ATOL, inside the JAX package's flat BF16_OUTER.  The
#: spread, sqrt(sum_j w_ij^2 v_jd^2) (``ref.swa_attention_spread_ref``),
#: scales the error of P rounded to bf16 (about 2^-8 / sqrt(3) of it, at
#: most 2^-8 sqrt(keys)), |plain| that of o rounded (2^-8).  A long band's
#: outputs are small (|o| ~ spread ~ sqrt(e / keys), 0.026 over 4096
#: keys), so the flat bound alone passes a kernel tens of percent off there
BF16_RTOL, BF16_ATOL, BF16_OUTER = 2e-2, 1e-4, 3e-2
#: kernel 21's odd shapes (B, S, H, KH, D, window): the JAX package's
#: test shapes, ragged S, one KV head, every D the models use, D = 256
ATTN_ODD = ((1, 64, 2, 2, 16, None), (2, 100, 4, 2, 32, 17),
            (1, 33, 4, 1, 16, 8), (1, 128, 2, 2, 64, 32),
            (1, 100, 4, 1, 128, None), (2, 300, 8, 2, 120, 50),
            (1, 70, 2, 1, 256, 33), (1, 1, 4, 2, 64, None),
            (1, 200, 4, 4, 8, 1))
#: kernel 21 at the families' bulk-prefill shapes (B, S, H, KH, D,
#: window): llama4-scout's 40 query heads over 8 KV heads of 128,
#: zamba2-1.2b's shared block's 32 over 32 of 64, internvl2-26b's 48 over
#: 8 of 128 over its 256 patches and 8192 tokens, whisper-medium's
#: decoder's 16 over 16 of 64; none has a window
FAMILY_ATTN = {'llama4-scout-17b-a16e': (1, 8192, 40, 8, 128, None),
               'zamba2-1.2b': (1, 8192, 32, 32, 64, None),
               'internvl2-26b': (1, 8448, 48, 8, 128, None),
               'whisper-medium': (1, 8192, 16, 16, 64, None)}


def _card_line() -> str:
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi unavailable ({e!r})'


def _time_ms(torch, fn, warm=WARM, timed=TIMED) -> float:
    """Mean milliseconds per call of ``fn`` over ``timed`` warm calls."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(timed):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / timed


def _record(name, source, replaces, err, ms, plain_ms, nbytes, flops,
            dense_bytes, library_ms=None, peak_flops=PEAK_FLOPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return {'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': None, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations',
            'library_ms': library_ms, 'bytes': nbytes, 'flops': flops,
            'dense_bytes': dense_bytes}


def aggregate_bytes(n, picked, undrafted, deprecated, completed=None):
    """Bytes one Eq. 6-8 launch over [m, n] rows must move for these masks
    (numpy bool [m]), with the cache written in place: trained only where
    picked or undrafted, cache read only where neither picked nor
    deprecated, cache written only where Eq. 8 changes the row, global
    read and new_global written once, masks and weights once.  With
    ``completed`` (the int8 form) the trained rows are q and scales where
    completed and base elsewhere, needed on every row because new_local
    is written on every row."""
    m = len(picked)
    row = 4 * n
    cache_rd = int((~picked & ~deprecated).sum())
    cache_wr = int((picked | deprecated | undrafted).sum())
    if completed is None:
        trained = int((picked | undrafted).sum()) * row
        per_client = 3 + 4
    else:
        done = int(completed.sum())
        trained = done * (n + 4 * (n // 128)) + (m - done) * row + m * row
        per_client = 4 + 4
    return trained + (cache_rd + cache_wr) * row + 2 * row + per_client * m


def kernel_phase(torch, n: int, fails: list) -> list:
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.comm_quant import (dequantize_packed,
                                                quantize_packed)
    from repro_torch.kernels.safa_aggregate import (safa_aggregate,
                                                    safa_aggregate_packed,
                                                    safa_aggregate_packed_q8)
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    host = {k: rng.random(M) < p
            for k, p in (('picked', 0.3), ('undrafted', 0.2),
                         ('deprecated', 0.2), ('completed', 0.7))}
    masks = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    w = torch.as_tensor(rng.dirichlet(np.ones(M)), dtype=torch.float32,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    cache0, trained, base, glob = (normal(M, n), normal(M, n), normal(M, n),
                                   normal(n))
    pk, ud, dp, cp = (masks[k] for k in ('picked', 'undrafted', 'deprecated',
                                         'completed'))
    mn = M * n
    recs = []

    def check(cond, what):
        if not cond:
            fails.append(what)
            print(f'FAIL kernels: {what}')

    def global_err(got, want, what):
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
              f'{what} new_global beyond rtol 1e-5 / atol 1e-6 '
              f'(max abs err {err:.3e})')
        return err

    # -- safa_aggregate_packed (Eq. 6-8, cache in place) ---------------------
    ng_ref, nc_ref = ref.safa_aggregate_ref(cache0, trained, glob, pk, ud,
                                            dp, w)
    cache = cache0.clone()
    ptr = cache.data_ptr()
    ng, nc = safa_aggregate_packed(cache, trained, glob, pk, ud, dp, w)
    torch.cuda.synchronize()
    check(nc.data_ptr() == ptr, 'safa_aggregate_packed cache not in place')
    check(torch.equal(nc, nc_ref), 'safa_aggregate_packed new_cache differs')
    err = global_err(ng, ng_ref, 'safa_aggregate_packed')
    ms = _time_ms(torch, lambda: safa_aggregate_packed(cache, trained, glob,
                                                       pk, ud, dp, w))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_ref(
        cache, trained, glob, pk, ud, dp, w), warm=2, timed=10)
    recs.append(_record(
        'safa_aggregate_packed', 'src/repro_torch/csrc/safa_aggregate.cu',
        'src/repro/kernels/safa_aggregate.py:86', err, ms, plain,
        aggregate_bytes(n, host['picked'], host['undrafted'],
                        host['deprecated']),
        2 * mn, 12 * mn + 8 * n + 7 * M))

    # the per-leaf route (use_kernel=True) launches the same kernel into a
    # fresh output; check it at the widest leaf's shape (f1: 2450 x 128)
    leaf = 2450 * 128
    lg, lc = safa_aggregate(cache0[:, :leaf], trained[:, :leaf],
                            glob[:leaf], pk, ud, dp, w)
    torch.cuda.synchronize()
    check(torch.equal(lc, nc_ref[:, :leaf]),
          'safa_aggregate (per leaf) new_cache differs')
    global_err(lg, ng_ref[:leaf], 'safa_aggregate (per leaf)')

    # -- quantize_packed ---------------------------------------------------
    q_ref, s_ref = ref.quantize_packed_ref(trained)
    q, s = quantize_packed(trained)
    torch.cuda.synchronize()
    check(torch.equal(q, q_ref), 'quantize_packed q differs')
    check(torch.equal(s, s_ref), 'quantize_packed scales differ')
    err = max((q.int() - q_ref.int()).abs().max().item(),
              (s - s_ref).abs().max().item())
    ms = _time_ms(torch, lambda: quantize_packed(trained))
    plain = _time_ms(torch, lambda: ref.quantize_packed_ref(trained),
                     warm=2, timed=10)
    wire = 5 * mn + 4 * (mn // 128)     # f32 values, int8 values, scales
    recs.append(_record(
        'quantize_packed', 'src/repro_torch/csrc/comm_quant.cu',
        'src/repro/kernels/comm_quant.py:111', err, ms, plain, wire, 3 * mn,
        wire))

    # -- dequantize_packed (the int8 wire's inverse: x = q * scale) ---------
    x = dequantize_packed(q_ref, s_ref)
    x_ref = ref.dequantize_packed_ref(q_ref, s_ref)
    torch.cuda.synchronize()
    check(torch.equal(x, x_ref), 'dequantize_packed differs from its plain '
                                 'version')
    ms = _time_ms(torch, lambda: dequantize_packed(q_ref, s_ref))
    plain = _time_ms(torch, lambda: ref.dequantize_packed_ref(q_ref, s_ref),
                     warm=2, timed=10)
    recs.append(_record(
        'dequantize_packed', 'src/repro_torch/csrc/comm_quant.cu',
        'src/repro/kernels/comm_quant.py:122',
        (x - x_ref).abs().max().item(), ms, plain, wire, mn, wire))

    # -- safa_aggregate_packed_q8 (dequant + Eq. 6-8, cache in place) --------
    ng_ref, nc_ref, nl_ref = ref.safa_aggregate_q8_ref(
        q_ref, s_ref, base, cache0, glob, pk, ud, dp, cp, w)
    cache = cache0.clone()
    ptr = cache.data_ptr()
    ng, nc, nl = safa_aggregate_packed_q8(q_ref, s_ref, base, cache, glob,
                                          pk, ud, dp, cp, w)
    torch.cuda.synchronize()
    check(nc.data_ptr() == ptr, 'safa_aggregate_packed_q8 cache not in place')
    check(torch.equal(nc, nc_ref), 'safa_aggregate_packed_q8 new_cache differs')
    check(torch.equal(nl, nl_ref), 'safa_aggregate_packed_q8 new_local differs')
    err = global_err(ng, ng_ref, 'safa_aggregate_packed_q8')
    ms = _time_ms(torch, lambda: safa_aggregate_packed_q8(
        q_ref, s_ref, base, cache, glob, pk, ud, dp, cp, w))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_q8_ref(
        q_ref, s_ref, base, cache, glob, pk, ud, dp, cp, w), warm=2,
        timed=10)
    recs.append(_record(
        'safa_aggregate_packed_q8', 'src/repro_torch/csrc/safa_aggregate.cu',
        'src/repro/kernels/safa_aggregate.py:255', err, ms, plain,
        aggregate_bytes(n, host['picked'], host['undrafted'],
                        host['deprecated'], host['completed']),
        3 * mn, 17 * mn + 4 * (mn // 128) + 8 * n + 8 * M))

    _print_records(recs)
    return recs


def _print_records(recs):
    for r in recs:
        lib = '' if r['library_ms'] is None else \
            f", one PyTorch call {r['library_ms']} ms"
        print(f"kernel {r['name']}: {r['ms']} ms (plain {r['plain_ms']} ms"
              f"{lib}), "
              f"bound {r['bound_ms']} ms by {r['bound_by']} "
              f"({r['bytes'] / 1e6:.1f} MB for these masks; every row read "
              f"and written: {r['dense_bytes'] / 1e6:.1f} MB, "
              f"{r['dense_bytes'] / PEAK_BYTES * 1e3} ms), max abs err "
              f"{r['max_abs_err']:.3e}")


def fleet_kernel_phase(torch, n: int, fails: list) -> list:
    """Kernels 7-9 (the fleet forms) at S = 4, m = 100, N = n, each member
    with its own seeded masks and weights: against the plain version on
    the stacked operands, and bit for bit against the single-run kernel on
    every member's slices."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.comm_quant import (dequantize_packed,
                                                dequantize_packed_fleet,
                                                quantize_packed,
                                                quantize_packed_fleet)
    from repro_torch.kernels.safa_aggregate import (
        safa_aggregate_packed, safa_aggregate_packed_fleet,
        safa_aggregate_packed_q8, safa_aggregate_packed_q8_fleet)
    dev = torch.device('cuda')
    rng = np.random.default_rng(1)
    host = {k: rng.random((S, M)) < p
            for k, p in (('picked', 0.3), ('undrafted', 0.2),
                         ('deprecated', 0.2), ('completed', 0.7))}
    pk, ud, dp, cp = (torch.as_tensor(host[k], device=dev)
                      for k in ('picked', 'undrafted', 'deprecated',
                                'completed'))
    w = torch.as_tensor(rng.dirichlet(np.ones(M), size=S),
                        dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    cache0, trained, base, glob = (normal(S, M, n), normal(S, M, n),
                                   normal(S, M, n), normal(S, n))
    mn = S * M * n
    recs = []

    def check(cond, what):
        if not cond:
            fails.append(what)
            print(f'FAIL fleet kernels: {what}')

    def global_err(got, want, what):
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
              f'{what} new_global beyond rtol 1e-5 / atol 1e-6 '
              f'(max abs err {err:.3e})')
        return err

    def summed_bytes(**masks):
        return sum(aggregate_bytes(n, *(masks[k][s] for k in masks))
                   for s in range(S))

    def per_member(name, got, single):
        """Fleet outputs against the single-run kernel, member by member."""
        same = all(torch.equal(g[s], o) for s in range(S)
                   for g, o in zip(got, single(s)))
        check(same, f'{name} differs from the single-run kernel on a member')

    # -- safa_aggregate_packed_fleet -----------------------------------------
    ng_ref, nc_ref = ref.safa_aggregate_ref(cache0, trained, glob, pk, ud,
                                            dp, w)
    cache = cache0.clone()
    ptr = cache.data_ptr()
    ng, nc = safa_aggregate_packed_fleet(cache, trained, glob, pk, ud, dp, w)
    torch.cuda.synchronize()
    check(nc.data_ptr() == ptr, 'safa_aggregate_packed_fleet not in place')
    check(torch.equal(nc, nc_ref), 'safa_aggregate_packed_fleet new_cache '
                                   'differs from the plain version')
    err = global_err(ng, ng_ref, 'safa_aggregate_packed_fleet')
    per_member('safa_aggregate_packed_fleet', (ng, nc),
               lambda s: safa_aggregate_packed(
                   cache0[s].clone(), trained[s], glob[s], pk[s], ud[s],
                   dp[s], w[s]))
    ms = _time_ms(torch, lambda: safa_aggregate_packed_fleet(
        cache, trained, glob, pk, ud, dp, w))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_ref(
        cache, trained, glob, pk, ud, dp, w), warm=2, timed=10)
    recs.append(_record(
        'safa_aggregate_packed_fleet', 'src/repro_torch/csrc/safa_aggregate.cu',
        'src/repro/kernels/safa_aggregate.py:98', err, ms, plain,
        summed_bytes(picked=host['picked'], undrafted=host['undrafted'],
                     deprecated=host['deprecated']),
        2 * mn, S * (12 * M * n + 8 * n + 7 * M)))

    # -- quantize_packed_fleet ---------------------------------------------
    q_ref, s_ref = ref.quantize_packed_ref(trained)
    q, sc = quantize_packed_fleet(trained)
    torch.cuda.synchronize()
    check(torch.equal(q, q_ref), 'quantize_packed_fleet q differs')
    check(torch.equal(sc, s_ref), 'quantize_packed_fleet scales differ')
    per_member('quantize_packed_fleet', (q, sc),
               lambda s: quantize_packed(trained[s]))
    err = max((q.int() - q_ref.int()).abs().max().item(),
              (sc - s_ref).abs().max().item())
    ms = _time_ms(torch, lambda: quantize_packed_fleet(trained))
    plain = _time_ms(torch, lambda: ref.quantize_packed_ref(trained),
                     warm=2, timed=10)
    wire = 5 * mn + 4 * (mn // 128)
    recs.append(_record(
        'quantize_packed_fleet', 'src/repro_torch/csrc/comm_quant.cu',
        'src/repro/kernels/comm_quant.py:128', err, ms, plain, wire, 3 * mn,
        wire))

    # -- dequantize_packed_fleet -------------------------------------------
    x = dequantize_packed_fleet(q_ref, s_ref)
    x_ref = ref.dequantize_packed_ref(q_ref, s_ref)
    torch.cuda.synchronize()
    check(torch.equal(x, x_ref), 'dequantize_packed_fleet differs from its '
                                 'plain version')
    per_member('dequantize_packed_fleet', (x,),
               lambda s: (dequantize_packed(q_ref[s], s_ref[s]),))
    ms = _time_ms(torch, lambda: dequantize_packed_fleet(q_ref, s_ref))
    plain = _time_ms(torch, lambda: ref.dequantize_packed_ref(q_ref, s_ref),
                     warm=2, timed=10)
    recs.append(_record(
        'dequantize_packed_fleet', 'src/repro_torch/csrc/comm_quant.cu',
        'src/repro/kernels/comm_quant.py:122',
        (x - x_ref).abs().max().item(), ms, plain, wire, mn, wire))

    # -- safa_aggregate_packed_q8_fleet ------------------------------------
    ng_ref, nc_ref, nl_ref = ref.safa_aggregate_q8_ref(
        q_ref, s_ref, base, cache0, glob, pk, ud, dp, cp, w)
    cache = cache0.clone()
    ptr = cache.data_ptr()
    ng, nc, nl = safa_aggregate_packed_q8_fleet(q_ref, s_ref, base, cache,
                                                glob, pk, ud, dp, cp, w)
    torch.cuda.synchronize()
    check(nc.data_ptr() == ptr, 'safa_aggregate_packed_q8_fleet not in place')
    check(torch.equal(nc, nc_ref), 'safa_aggregate_packed_q8_fleet new_cache '
                                   'differs from the plain version')
    check(torch.equal(nl, nl_ref), 'safa_aggregate_packed_q8_fleet new_local '
                                   'differs from the plain version')
    err = global_err(ng, ng_ref, 'safa_aggregate_packed_q8_fleet')
    per_member('safa_aggregate_packed_q8_fleet', (ng, nc, nl),
               lambda s: safa_aggregate_packed_q8(
                   q_ref[s], s_ref[s], base[s], cache0[s].clone(), glob[s],
                   pk[s], ud[s], dp[s], cp[s], w[s]))
    ms = _time_ms(torch, lambda: safa_aggregate_packed_q8_fleet(
        q_ref, s_ref, base, cache, glob, pk, ud, dp, cp, w))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_q8_ref(
        q_ref, s_ref, base, cache, glob, pk, ud, dp, cp, w), warm=2,
        timed=10)
    recs.append(_record(
        'safa_aggregate_packed_q8_fleet',
        'src/repro_torch/csrc/safa_aggregate.cu',
        'src/repro/kernels/safa_aggregate.py:271', err, ms, plain,
        summed_bytes(picked=host['picked'], undrafted=host['undrafted'],
                     deprecated=host['deprecated'],
                     completed=host['completed']),
        3 * mn, S * (17 * M * n + 4 * (M * n // 128) + 8 * n + 8 * M)))

    _print_records(recs)
    return recs


def merge_kernel_phase(torch, n: int, fails: list) -> list:
    """Kernel 10 (the weighted merge) at m = 100, N = n, and its fleet
    form at S = 4, on seeded weight rows that are zero off a seeded commit
    mask and sum to 0.6: against the plain version, the fleet form bit for
    bit against the single-run kernel on every member, and each beside
    one PyTorch call that computes the same function (timed here only;
    the port never calls it)."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.weighted_merge import (
        weighted_merge_packed, weighted_merge_packed_fleet)
    dev = torch.device('cuda')
    rng = np.random.default_rng(2)
    commit = rng.random((S, M)) < 0.7
    w = rng.random((S, M)) * commit
    w = 0.6 * w / w.sum(1, keepdims=True)
    wrow = torch.as_tensor(w, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    trained = torch.randn((S, M, n), generator=gen, device=dev)
    glob = torch.randn((S, n), generator=gen, device=dev)
    recs = []

    def check(cond, what):
        if not cond:
            fails.append(what)
            print(f'FAIL merge kernels: {what}')

    def global_err(got, want, what):
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
              f'{what} beyond rtol 1e-5 / atol 1e-6 (max abs err '
              f'{err:.3e})')
        return err

    def merge_bytes(rows):
        """Weighted rows read, global read, new global written, weights."""
        return 4 * (int(rows.sum()) * n + 2 * n + M)

    # -- weighted_merge_packed (one run: member 0's operands) -------------
    t0, g0, w0 = trained[0], glob[0], wrow[0]
    want = ref.weighted_merge_ref(t0, g0, w0)
    got = weighted_merge_packed(t0, g0, w0)
    torch.cuda.synchronize()
    err = global_err(got, want, 'weighted_merge_packed')
    ms = _time_ms(torch, lambda: weighted_merge_packed(t0, g0, w0))
    plain = _time_ms(torch, lambda: ref.weighted_merge_ref(t0, g0, w0),
                     warm=2, timed=10)
    beta = 1.0 - w0.sum().item()        # outside the timed window

    def addmv():
        return torch.addmv(g0, t0.t(), w0, beta=beta, alpha=1.0)
    global_err(addmv(), want, 'torch.addmv (the yardstick)')
    lib = _time_ms(torch, addmv)
    nnz = int(commit[0].sum())
    recs.append(_record(
        'weighted_merge_packed', 'src/repro_torch/csrc/weighted_merge.cu',
        'src/repro/kernels/ops.py:453', err, ms, plain, merge_bytes(commit[0]),
        2 * (nnz + 1) * n, 4 * ((M + 2) * n + M), library_ms=lib))

    # -- weighted_merge_packed_fleet -----------------------------------------
    want = ref.weighted_merge_ref(trained, glob, wrow)
    got = weighted_merge_packed_fleet(trained, glob, wrow)
    torch.cuda.synchronize()
    err = global_err(got, want, 'weighted_merge_packed_fleet')
    check(all(torch.equal(got[s], weighted_merge_packed(trained[s], glob[s],
                                                        wrow[s]))
              for s in range(S)),
          'weighted_merge_packed_fleet differs from the single-run kernel '
          'on a member')
    ms = _time_ms(torch, lambda: weighted_merge_packed_fleet(trained, glob,
                                                             wrow))
    plain = _time_ms(torch, lambda: ref.weighted_merge_ref(trained, glob,
                                                           wrow),
                     warm=2, timed=10)
    # the yardstick: one bmm of [w, 1 - sum(w)] against the stack with the
    # global row appended, both built outside the timed window
    a = torch.cat([wrow, 1.0 - wrow.sum(1, keepdim=True)], 1)[:, None]
    b = torch.cat([trained, glob[:, None]], 1)
    global_err(torch.bmm(a, b)[:, 0], want, 'torch.bmm (the yardstick)')
    lib = _time_ms(torch, lambda: torch.bmm(a, b))
    del a, b
    recs.append(_record(
        'weighted_merge_packed_fleet',
        'src/repro_torch/csrc/weighted_merge.cu',
        'src/repro/kernels/ops.py:453', err, ms, plain,
        sum(merge_bytes(commit[s]) for s in range(S)),
        2 * (int(commit.sum()) + S) * n, S * 4 * ((M + 2) * n + M),
        library_ms=lib))
    _print_records(recs)
    return recs


#: the Task 2 CNN's leaves in sorted-key order (b1, b2, c1, c2, f1, fb1,
#: f2, fb2): the per-leaf path quantises each client's row of each
CNN_LEAVES = (20, 50, 500, 25_000, 313_600, 128, 1280, 10)


def leaf_bytes(n: int) -> int:
    """Bytes one quantise (or dequantise) launch on an [n] vector moves:
    the f32 values, the int8 values and the ceil(n / 128) f32 scales."""
    return 5 * n + 4 * -(-n // 128)


def leaf_kernel_phase(torch, fails: list) -> list:
    """Kernels 5 and 6 (the per-leaf reference's quantise and dequantise)
    on seeded [100, n] stacks at the CNN's eight leaf sizes: the flat
    entries on every row view, and the rows entries (one launch a row
    from one C call, what the per-leaf path runs) on each whole stack,
    both bit for bit against their plain versions and each other.  Timed
    at the largest leaf (f1, n = 313,600) and the smallest (fb2, n = 10),
    where the launch and not the bytes sets the time: a flat call, and a
    rows-entry launch (events over the m launches of a call / m)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.comm_quant import (dequantize, dequantize_rows,
                                                quantize, quantize_rows)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(5)
    bad, bad_stacks, errs = [], [], {'quantize': 0.0, 'dequantize': 0.0}
    stacks = {}

    def err(name, got, want):
        errs[name] = max(errs[name],
                         (got.double() - want.double()).abs().max().item())

    for n in CNN_LEAVES:
        x = torch.randn((M, n), generator=gen, device=dev) * 0.1
        x[0, :min(n, 128)] = 0.0          # an all-zero block
        stacks[n] = x
        flat = []
        for k in range(M):
            want_q, want_s = ref.quantize_ref(x[k])
            want_x = ref.dequantize_ref(want_q, want_s, n)
            q, s = quantize(x[k])
            back = dequantize(want_q, want_s, n=n)
            if not (torch.equal(q, want_q) and torch.equal(s, want_s)
                    and torch.equal(back, want_x)):
                bad.append((n, k))
            err('quantize', q, want_q)
            err('quantize', s, want_s)
            err('dequantize', back, want_x)
            flat.append((q, s, back))
        want_q, want_s = ref.quantize_ref(x)
        want_x = ref.dequantize_ref(want_q, want_s, n)
        q, s = quantize_rows(x)
        back = dequantize_rows(want_q, want_s, n=n)
        fq, fs, fx = (torch.stack(t) for t in zip(*flat))
        if not (torch.equal(q, want_q) and torch.equal(s, want_s)
                and torch.equal(back, want_x) and torch.equal(q, fq)
                and torch.equal(s, fs) and torch.equal(back, fx)):
            bad_stacks.append(n)
        err('quantize', q, want_q)
        err('quantize', s, want_s)
        err('dequantize', back, want_x)
    torch.cuda.synchronize()
    print(f'leaf kernels: quantize and dequantize on {len(CNN_LEAVES)} leaf '
          f'sizes x {M} row views, {len(bad)} rows differ from the plain '
          f'versions; the rows entries on the {len(CNN_LEAVES)} [{M}, n] '
          f'stacks, {len(bad_stacks)} stacks differ from the plain versions '
          f'or the flat entries')
    if bad:
        fails.append(f'leaf kernels differ from their plain versions at '
                     f'(n, row) {bad[:8]}')
    if bad_stacks:
        fails.append(f'the rows entries differ from the plain versions or '
                     f'the flat entries at n = {bad_stacks}')
    times = {}
    for n in (313_600, 10):
        x = stacks[n]
        row = x[M // 2 + 1]
        qs, qs_rows = ref.quantize_ref(row), ref.quantize_ref(x)
        for name, flat, rows, plain in (
                ('quantize', lambda: quantize(row), lambda: quantize_rows(x),
                 lambda: ref.quantize_ref(x)),
                ('dequantize', lambda: dequantize(*qs, n=n),
                 lambda: dequantize_rows(*qs_rows, n=n),
                 lambda: ref.dequantize_ref(*qs_rows, n))):
            times[name, n] = (_time_ms(torch, rows) / M,
                              _time_ms(torch, plain, warm=2, timed=10) / M,
                              _time_ms(torch, flat))
            rows_ms, plain_ms, flat_ms = times[name, n]
            print(f'leaf kernel {name} at n = {n}: rows entry {rows_ms} ms a '
                  f'launch (events over {M} launches / {M}; plain {plain_ms} '
                  f'ms a row), flat call {flat_ms} ms, bound '
                  f'{leaf_bytes(n) / PEAK_BYTES * 1e3} ms by bytes '
                  f'({leaf_bytes(n)} B)')
    leaf_device_time(torch, stacks, times)
    n = 313_600
    recs = [_record(name, 'src/repro_torch/csrc/comm_quant.cu',
                    f'src/repro/kernels/comm_quant.py:{line}', errs[name],
                    *times[name, n][:2], leaf_bytes(n), ops, leaf_bytes(n))
            for name, line, ops in (('quantize', 47, 3 * n),
                                    ('dequantize', 57, n))]
    _print_records(recs)
    return recs


def leaf_device_time(torch, stacks, times):
    """Kernels 5 and 6's device time a launch at n = 313,600 and at
    n = 10 (the card's floor for one launch), each from a
    ``torch.profiler`` window over 100 launches of each kernel: one
    rows-entry call (distinct rows, as the per-leaf path reads them),
    then as a control the flat entry on the same distinct rows and on
    one row 100 times (which the 50 MB L2 cache then holds).  Printed
    beside the CUDA-event times.  A measurement only: a profiler that
    cannot trace the card leaves the phase's verdict alone, but a kernel
    that fails to launch raises."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.comm_quant import (dequantize, dequantize_rows,
                                                quantize, quantize_rows)
    for n in (313_600, 10):
        x = stacks[n]
        qs = ref.quantize_ref(x)
        row, row_qs = x[M // 2 + 1], (qs[0][M // 2 + 1], qs[1][M // 2 + 1])

        def rows():
            quantize_rows(x)
            dequantize_rows(*qs, n=n)

        def flat_rows():
            for k in range(M):
                quantize(x[k])
            for k in range(M):
                dequantize(qs[0][k], qs[1][k], n=n)

        def flat_one_row():
            for _ in range(M):
                quantize(row)
            for _ in range(M):
                dequantize(*row_qs, n=n)

        for label, fn in (('rows entry', rows),
                          ('flat entry, distinct rows', flat_rows),
                          ('flat entry, one row', flat_one_row)):
            spans = _device_spans(torch, fn)
            if spans is None:
                return
            for name in ('quantize', 'dequantize'):
                us = [t for k, t in spans if f'{name}_kernel' in k
                      and (name == 'dequantize' or 'dequantize' not in k)]
                if not us:
                    print(f'leaf kernel {name} at n = {n}: device time not '
                          f'measured (no such kernel in the trace)')
                    continue
                rows_ms, _, flat_ms = times[name, n]
                print(f'leaf kernel {name} at n = {n}, {label}: device '
                      f'{sum(us) / len(us)} us a launch '
                      f'(torch.profiler, {len(us)} launches) beside '
                      f'{rows_ms * 1e3} us a rows-entry launch and '
                      f'{flat_ms * 1e3} us a flat call by CUDA events')


def _device_spans(torch, fn):
    """(kernel name, device microseconds) of every launch while ``fn()``
    runs, from one ``torch.profiler`` window, or None (printed) if the
    profiler cannot trace the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 - report and go on
        print(f'device time: not measured ({e!r})')
        return None
    fn()
    torch.cuda.synchronize()
    try:
        prof.stop()
        spans = {(e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type.name == 'CUDA'}
    except Exception as e:  # noqa: BLE001 - report and go on
        print(f'device time: not measured ({e!r})')
        return None
    return [(k, stop - start) for start, stop, k in spans]


def scale_spec(seed=0, m=SCALE_M):
    """``repro_torch.fedsim.scale.scale_spec`` at the smoke's quota: the
    quota-bounded environment of the JAX package's ``benchmarks/scale.py``
    with the Task 2 data, batch and epochs, m clients (1000 unless
    given)."""
    from repro_torch.fedsim import scale
    return scale.scale_spec(seed, m, quota=QUOTA)


def scale_schedule(rounds, seed=0, form='sparse', m=SCALE_M):
    """SAFA's sparse (or lag-tier) schedule on ``scale_spec(seed, m)``
    (``repro_torch.fedsim.scale.scale_schedule``)."""
    from repro_torch.fedsim import scale
    return scale.scale_schedule(rounds, seed, form, m=m, quota=QUOTA)


def rows_bytes(h_rows, h_roles, n):
    """Bytes (these roles' need, and every slot's) and operations one
    launch of each rows kernel moves for one member's slots ``h_rows``,
    ``h_roles`` (numpy [K]) at width n: name -> (bytes, flops,
    dense_bytes).  A fleet launch moves the sum over its members."""
    import numpy as np

    from repro_torch.core import protocol
    k = len(h_rows)
    row, kn = 4 * n, k * n
    distinct = len(np.unique(h_rows))
    p = (h_roles & protocol.ROLE_PICKED) != 0
    u = (h_roles & protocol.ROLE_UNDRAFTED) != 0
    done = int(((h_roles & protocol.ROLE_COMMITTED) != 0).sum())
    slot_bytes = 9 * k                      # rows, roles, weights
    wire_row = n + 4 * (n // 128)
    return {
        'gather': (distinct * row + k * row + slot_bytes, 0, 2 * k * row),
        'scatter': (2 * distinct * row + slot_bytes, 0, 2 * k * row),
        'rows': (distinct * row + int((p | u).sum()) * row + k * row
                 + 4 * row + slot_bytes, 4 * kn,
                 3 * k * row + 4 * row + slot_bytes),
        'q8_rows': (done * wire_row + (k - done) * row + distinct * row
                    + 2 * k * row + 4 * row + slot_bytes, 5 * kn,
                    k * wire_row + 4 * k * row + 4 * row + slot_bytes)}


def tier_bytes(h_srcs, h_dsts, h_roles, n):
    """Bytes (these slot maps' and roles' need, and every slot's) and
    operations one launch of each tier kernel moves for one member's
    slots (numpy [K]) at width n: name -> (bytes, flops, dense_bytes).
    Each distinct row read once, the trained row (int8: q and scales
    where the slot committed, base elsewhere) only where the slot is
    picked or undrafted, each distinct destination row written once
    (the last slot wins it), global and agg read and the two new vectors
    written once.  A fleet launch moves the sum over its members."""
    import numpy as np

    from repro_torch.core import protocol
    k = len(h_srcs)
    row, kn = 4 * n, k * n
    reads, writes = len(np.unique(h_srcs)), len(np.unique(h_dsts))
    need = (h_roles & (protocol.ROLE_PICKED | protocol.ROLE_UNDRAFTED)) != 0
    done = (h_roles & protocol.ROLE_COMMITTED) != 0
    slot_bytes = 13 * k                     # srcs, dsts, roles, weights
    wire_row = n + 4 * (n // 128)
    vectors = 4 * row + slot_bytes
    return {
        'tier': ((reads + writes + int(need.sum())) * row + vectors, 4 * kn,
                 3 * k * row + vectors),
        'q8_tier': ((reads + writes + int((need & ~done).sum())) * row
                    + int((need & done).sum()) * wire_row + vectors, 5 * kn,
                    2 * k * row + k * wire_row + vectors)}


def _launch_shape(entry: str, keys, *args):
    """The launch shape a kernel's C query ``entry(*args, out)`` reports on
    this card, as a dict of ``keys``, or None where the library has no
    such entry (a tree whose kernel has no query)."""
    import ctypes

    from repro_torch.kernels import backend
    lib, _ = backend.load_library()
    fn = getattr(lib, entry, None)
    if fn is None:
        return None
    out = (ctypes.c_longlong * len(keys))()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f'{entry}: cudaError_t {err}')
    return dict(zip(keys, out))


def q8_tier_grid(torch, s: int, n: int):
    """How kernel 20 launches for s members of width n on this card
    (``safa_q8_tier_rows_grid``), or None where the library has no such
    entry (the register-tiled kernel this ring replaced)."""
    return _launch_shape('safa_q8_tier_rows_grid',
                         ('tile', 'stages', 'smem', 'per_sm', 'blocks',
                          'per_block'), s, n)


def tier_in_flight(kernel, roles, grid):
    """Bytes of loads a block keeps in flight by its design, for the
    slots' roles (numpy [K] per member): kernels 19 and the register-tiled
    20 issue kGroup = 4 slots' loads a thread, 256 threads a block (c0 16
    bytes, and where the slot needs its trained row 16 bytes, or a char4
    of q and a scale that the warp's 32 lanes share); the ring of kernel
    20 holds ``stages`` slots' segments (c0 4 x tile bytes, q tile bytes
    and tile / 32 of scales, or a 4 x tile base segment)."""
    import numpy as np

    from repro_torch.core import protocol
    r = np.concatenate([np.asarray(x) for x in roles])
    need = (r & (protocol.ROLE_PICKED | protocol.ROLE_UNDRAFTED)) != 0
    done = (r & protocol.ROLE_COMMITTED) != 0
    if kernel == 'tier':
        return 256 * 4 * float(np.mean(16 + 16 * need))
    if grid is None:
        return 256 * 4 * float(np.mean(16 + (need & done) * (4 + 4 / 32)
                                       + (need & ~done) * 16))
    t = grid['tile']
    return grid['stages'] * float(np.mean(4 * t + (need & done) * (t + t / 32)
                                          + (need & ~done) * 4 * t))


def _print_tier_time(name, t, ms, nbytes, kernel, roles, grid):
    bound = nbytes / PEAK_BYTES * 1e3
    line = (f'tier time {name} round {t + 1}: {ms} ms, bound {bound} ms '
            f'({nbytes / 1e6:.1f} MB), {bound / ms:.1%} of it, achieved '
            f'{nbytes / ms / 1e9:.3f} TB/s; design in flight '
            f'{tier_in_flight(kernel, roles, grid) / 1e3:.1f} KB a block')
    if kernel == 'q8_tier' and grid is not None:
        line += (f' (ring: tile {grid["tile"]}, {grid["stages"]} stages, '
                 f'{grid["smem"]} B shared, {grid["per_sm"]} blocks an SM, '
                 f'{grid["blocks"]} blocks x {grid["per_block"]} items)')
    print(line)


def tier_kernel_phase(torch, n: int, fails: list) -> list:
    """Kernels 19 and 20 and their S-axis forms on the slot maps of the
    m = 1000 quota-bounded lag-tier schedule of two rounds (the tier
    phase's runs): round 2 (K = 124 slots, every c2 aimed at the
    scratch row, the last slot winning it) and round 1 (121 rows written
    in place, three sentinel slots) of a buffer of capacity + 1 = 123
    rows; the S-axis forms on round 2 of the four-member tier fleet of
    env seeds 0-3 (each member padded with sentinel slots to the fleet's
    K = 125, capacity + 1 = 126 rows).  Each against its plain version
    (the whole buffer, scratch row included, bit for bit; new_global and
    new_agg within 5e-7), twice, each member of an S-axis launch bit for
    bit its single launch; timed on both rounds (one line each: ms, bound,
    share, achieved TB/s, the design's bytes in flight a block), the
    records round 2's."""
    import numpy as np

    from repro_torch.core import protocol
    from repro_torch.core.schedules import TierFleetSchedule
    from repro_torch.kernels import ref
    from repro_torch.kernels.safa_aggregate import (
        safa_aggregate_packed_q8_tier_rows,
        safa_aggregate_packed_q8_tier_rows_fleet,
        safa_aggregate_packed_tier_rows,
        safa_aggregate_packed_tier_rows_fleet)
    dev = torch.device('cuda')
    sched = scale_schedule(2, form='sparse_tier')
    fleet = TierFleetSchedule.from_members(
        [scale_schedule(2, seed=i, form='sparse_tier') for i in range(S)])
    weights = torch.as_tensor(scale_spec().build().weights,
                              dtype=torch.float32, device=dev)
    f_weights = torch.as_tensor(
        np.stack([scale_spec(i).build().weights for i in range(S)]),
        dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def maps(sc, t, w):
        """Round t's (srcs, dsts, roles, slot weights) on the card."""
        idx = put(sc.idx[..., t, :])
        return (put(sc.cache_src[..., t, :]), put(sc.cache_dst[..., t, :]),
                put(sc.roles[..., t, :]), protocol._slot_weights(idx, w))

    recs = []

    def check(cond, what):
        if not cond:
            fails.append(what)
            print(f'FAIL tier kernels: {what}')

    def vec_err(got, want, what):
        err = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
        check(err <= 5e-7, f'{what} new_global/new_agg beyond 5e-7 '
                           f'(max abs err {err:.3e})')
        return err

    def args_of(kernel, buf, trained, base, glob, agg, m4):
        if kernel == 'tier':
            return (buf, trained, glob, agg) + m4
        q, sc = ref.quantize_packed_ref(trained)
        return (q, sc, base, buf, glob, agg) + m4

    def hold(kernel, wrapper, plain, shape, m4, what):
        """Wrapper against plain on fresh seeded operands, twice; returns
        (err, the launch's outputs, its operands)."""
        lead = shape[:-2]
        k = m4[0].shape[-1]
        ops = (normal(*shape), normal(*lead, k, n), normal(*lead, k, n),
               normal(*lead, n), normal(*lead, n))
        want = plain(*args_of(kernel, ops[0].clone(), *ops[1:], m4))
        got = [wrapper(*args_of(kernel, ops[0].clone(), *ops[1:], m4))
               for _ in range(2)]
        torch.cuda.synchronize()
        check(torch.equal(got[0][2], want[2]),
              f'{what}: the buffer differs from the plain version\'s')
        check(all(torch.equal(a, b) for a, b in zip(*got)),
              f'{what} differs between launches')
        return vec_err(got[0][:2], want[:2], what), got[0], ops

    h = {'scratch': sched.scratch, 'dup': [], 'pad': []}
    for t in (1, 0):
        h['dup'].append(int((sched.cache_dst[t] == sched.scratch).sum()))
        h['pad'].append(int((sched.idx[t] == sched.m).sum()))
    print(f'tier: m = {sched.m}, capacity {sched.capacity} (buffer rows '
          f'{sched.capacity + 1}), K = {sched.width} at N = {n}; rounds 2 '
          f'and 1: {h["dup"]} slots aim at the scratch row, {h["pad"]} '
          f'sentinel slots; fleet of {S}: K = {fleet.width} (members\' own '
          f'{fleet.widths.tolist()}), capacity {fleet.capacity} (members\' '
          f'own {fleet.capacities.tolist()})')
    check(h['dup'][0] > 1 and sum(h['pad']) > 0
          and int((fleet.idx[:, 1] == fleet.m).sum()) > 0,
          'the slot maps hold no duplicate scratch destination or no '
          'sentinel slot')
    r = sched.capacity + 1
    kernels = [('tier', safa_aggregate_packed_tier_rows,
                safa_aggregate_packed_tier_rows_fleet,
                ref.safa_aggregate_tier_rows_ref,
                'src/repro/kernels/safa_aggregate.py:789'),
               ('q8_tier', safa_aggregate_packed_q8_tier_rows,
                safa_aggregate_packed_q8_tier_rows_fleet,
                ref.safa_aggregate_q8_tier_rows_ref,
                'src/repro/kernels/safa_aggregate.py:876')]
    grids = {1: q8_tier_grid(torch, 1, n), S: q8_tier_grid(torch, S, n)}
    for kernel, single, s_axis, plain, replaces in kernels:
        name = f'safa_aggregate_packed_{kernel}_rows'
        for t in (0, 1):
            m4 = maps(sched, t, weights)
            err, _, ops = hold(kernel, single, plain, (r, n), m4,
                               f'{name} (round {t + 1})')
            args = args_of(kernel, ops[0], *ops[1:], m4)
            ms = _time_ms(torch, lambda: single(*args))
            need = tier_bytes(sched.cache_src[t], sched.cache_dst[t],
                              sched.roles[t], n)[kernel]
            _print_tier_time(name, t, ms, need[0], kernel,
                             [sched.roles[t]], grids[1])
            if t == 1:
                plain_ms = _time_ms(torch, lambda: plain(*args), warm=2,
                                    timed=10)
                recs.append(_record(name, 'src/repro_torch/csrc/safa_rows.cu',
                                    replaces, err, ms, plain_ms, *need))
            del args, ops

        fr = fleet.capacity + 1
        for t in (0, 1):
            fm = maps(fleet, t, f_weights)
            err, got, ops = hold(kernel, s_axis, plain, (S, fr, n), fm,
                                 f'{name}_fleet (round {t + 1})')
            base_args = args_of(kernel, ops[0], *ops[1:], fm)
            for i in range(S):
                one = single(*(a[i].clone() if a is ops[0] else a[i]
                               for a in base_args))
                check(all(torch.equal(g[i], w_) for g, w_ in zip(got, one)),
                      f'{name}_fleet member {i} differs from the single '
                      f'launch (round {t + 1})')
            ms = _time_ms(torch, lambda: s_axis(*base_args))
            per = [tier_bytes(fleet.cache_src[i, t], fleet.cache_dst[i, t],
                              fleet.roles[i, t], n)[kernel]
                   for i in range(S)]
            need = [sum(x[j] for x in per) for j in range(3)]
            _print_tier_time(name + '_fleet', t, ms, need[0], kernel,
                             list(fleet.roles[:, t]), grids[S])
            if t == 1:
                plain_ms = _time_ms(torch, lambda: plain(*base_args),
                                    warm=2, timed=10)
                recs.append(_record(name + '_fleet',
                                    'src/repro_torch/csrc/safa_rows.cu',
                                    replaces, err, ms, plain_ms, *need))
            del base_args, ops, got
    _print_records(recs)
    q8_tier_stress(torch, n, fails, sched, fleet, weights, f_weights)
    return recs


STRESS_LAUNCHES = 200   # kernel 20 launches a shape in the stress check


def q8_tier_stress(torch, n: int, fails: list, sched, fleet, weights,
                   f_weights) -> None:
    """Kernel 20 and its S-axis form launched ``STRESS_LAUNCHES`` times
    back to back at each of the smoke's tier shapes (m = 1000 rounds 1
    and 2, the S = 4 fleet's rounds 1 and 2, m = 10,000 rounds 1 and 2),
    each launch on a fresh copy of the same buffer: its buffer must equal
    the plain version's bit for bit, and its new_global and new_agg the
    first launch's (which is held to the plain version within 5e-7).  A
    stage released before its reads have landed, and overwritten by the
    next bulk copy, would show as a launch that differs.  The comparisons
    run on the card, one host read a shape."""
    import numpy as np

    from repro_torch.core import protocol
    from repro_torch.kernels import ref
    from repro_torch.kernels.safa_aggregate import (
        safa_aggregate_packed_q8_tier_rows,
        safa_aggregate_packed_q8_tier_rows_fleet)
    dev = torch.device('cuda')
    big = scale_schedule(2, form='sparse_tier', m=10 * SCALE_M)
    big_w = torch.as_tensor(scale_spec(m=10 * SCALE_M).build().weights,
                            dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    shapes = []
    for label, sc, w, lead in (('m = 1000', sched, weights, ()),
                               (f'S = {S}, m = 1000', fleet, f_weights,
                                (S,)),
                               ('m = 10,000', big, big_w, ())):
        for t in (0, 1):
            idx = put(sc.idx[..., t, :])
            shapes.append((f'{label}, round {t + 1}', lead, sc.capacity + 1,
                           (put(sc.cache_src[..., t, :]),
                            put(sc.cache_dst[..., t, :]),
                            put(sc.roles[..., t, :]),
                            protocol._slot_weights(idx, w))))
    for label, lead, rows, m4 in shapes:
        k = m4[0].shape[-1]
        wrapper = safa_aggregate_packed_q8_tier_rows_fleet if lead \
            else safa_aggregate_packed_q8_tier_rows

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        buf0 = normal(*lead, rows, n)
        q, scales = ref.quantize_packed_ref(normal(*lead, k, n))
        base, glob, agg = (normal(*lead, k, n), normal(*lead, n),
                           normal(*lead, n))
        want = ref.safa_aggregate_q8_tier_rows_ref(
            q, scales, base, buf0.clone(), glob, agg, *m4)
        buf = torch.empty_like(buf0)
        bad_buf = torch.zeros((), dtype=torch.int64, device=dev)
        bad_sums = torch.zeros((), dtype=torch.int64, device=dev)
        first = None
        t0 = time.perf_counter()
        for i in range(STRESS_LAUNCHES):
            buf.copy_(buf0)
            ng, na, _ = wrapper(q, scales, base, buf, glob, agg, *m4)
            bad_buf += (buf != want[2]).any()
            if first is None:
                first = (ng, na)
            else:
                bad_sums += (ng != first[0]).any() | (na != first[1]).any()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        err = max((g - w_).abs().max().item()
                  for g, w_ in zip(first, want[:2]))
        nb, ns = int(bad_buf), int(bad_sums)
        print(f'kernel 20 stress, {label} (K = {k}, {rows} buffer rows): '
              f'{STRESS_LAUNCHES} launches in {secs:.2f} s, {nb} with a '
              f'buffer off the plain version\'s, {ns} with sums off the '
              f'first launch\'s; first launch within {err:.3e} of the '
              f'plain sums')
        if nb or ns or err > 5e-7:
            fails.append(f'kernel 20 stress, {label}: {nb} launches with '
                         f'a wrong buffer, {ns} with other sums, first '
                         f'launch {err:.3e} from the plain version')
        del buf0, buf, q, scales, base, want, first
    torch.cuda.empty_cache()


def gather_grid(torch, s: int, k: int, n: int):
    """How kernels 11 and 13 launch for s members of k slots of width n on
    this card (``gather_rows_grid``), or None where the library has no
    such entry (the register-staged gather that the ring replaced)."""
    return _launch_shape('gather_rows_grid',
                         ('stage', 'stages', 'smem', 'per_sm', 'blocks',
                          'run'), s, k, n)


def _device_ms(torch, fn, calls=20):
    """Device milliseconds a launch of ``fn`` (one kernel a call) from one
    ``torch.profiler`` window over ``calls`` calls, and the launches it
    saw; (None, 0) where the profiler cannot trace the card."""
    spans = _device_spans(torch, lambda: [fn() for _ in range(calls)])
    if not spans:
        return None, 0
    return sum(us for _, us in spans) / len(spans) / 1e3, len(spans)


def gather_paper_shapes():
    """Slot rows (round 2) of the m = 100 sparse runs on the paper's
    environment (crash 0.3, C = 0.3, tau = 5, as the sparse phase runs
    them): SAFA's (K = 94) and FedAvg's (K = 30), each over R = m + 1
    rows: [(label, R, rows)]."""
    from repro_torch.configs import PAPER_TASKS
    from repro_torch.core import federation
    from repro_torch.fedsim import EnvSpec
    cfg = PAPER_TASKS['task2_cnn']
    spec = EnvSpec(m=cfg['m'], crash_prob=0.3,
                   dataset_size=cfg['dataset_size'],
                   batch_size=cfg['batch_size'], epochs=cfg['epochs'],
                   t_lim=cfg['t_lim'], seed=0)
    safa = federation.precompute_safa_schedule(
        spec.build(), fraction=0.3, lag_tolerance=5, rounds=2, form='sparse')
    fedavg = federation.precompute_sync_schedule(
        spec.build(), fraction=0.3, rounds=2, seed=0, fedcs=False,
        form='sparse')
    return [(f'm = {spec.m} SAFA sparse', spec.m + 1, safa.idx[1]),
            (f'm = {spec.m} FedAvg sparse', spec.m + 1, fedavg.idx[1])]


def gather_tier_shapes():
    """Base-row maps (round 2) of the lag tier's two-round schedules at
    m = 1000 and m = 10,000 (as the tier phase runs them), each over its
    value buffer of capacity + 1 rows: [(label, R, rows)]."""
    out = []
    for m in (SCALE_M, TIER_M):
        sc = scale_schedule(2, form='sparse_tier', m=m)
        out.append((f'm = {m} tier value buffer', sc.capacity + 1,
                    sc.base_src[1]))
    return out


def gather_times(torch, label, buf, rows, h_rows, fails):
    """Kernel 11 (13 for a [S, R, N] ``buf``) at one shape the main path
    gives it, against the plain version and ``torch.index_select`` (on
    the [S R, N] view for a fleet) bit for bit, twice; then timed twice by
    CUDA events over back-to-back calls, ``index_select`` beside each in
    turns (kernel, library, kernel, library), and each launch's device
    time from ``torch.profiler``.  Prints one line (the launch's grid,
    segment size and ring depth included) and returns the two kernel
    and the two ``index_select`` times by events, in ms."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.rows import gather_rows, gather_rows_fleet
    fleet = buf.ndim == 3
    s = buf.shape[0] if fleet else 1
    r, n = buf.shape[-2:]
    k = rows.shape[-1]
    wrapper = gather_rows_fleet if fleet else gather_rows
    view = buf.reshape(s * r, n)
    fixed = torch.where((rows < 0) | (rows >= r), r - 1, rows.long())
    flat = (fixed.reshape(s, k)
            + r * torch.arange(s, device=buf.device)[:, None]).reshape(-1)
    got = wrapper(buf, rows)
    again = wrapper(buf, rows)
    lib_out = torch.index_select(view, 0, flat).view(got.shape)
    torch.cuda.synchronize()
    ok = (torch.equal(got, ref.gather_rows_ref(buf, rows))
          and torch.equal(got, lib_out) and torch.equal(got, again))
    if not ok:
        fails.append(f'gather {label}: differs from its plain version, '
                     f'from index_select or between launches')
        print(f'FAIL gather {label}: differs from its plain version, from '
              f'index_select or between launches')
    del got, again, lib_out
    ms, lib = [], []
    for _ in range(2):
        ms.append(_time_ms(torch, lambda: wrapper(buf, rows)))
        lib.append(_time_ms(torch, lambda: torch.index_select(view, 0,
                                                              flat)))
    dev, n_dev = _device_ms(torch, lambda: wrapper(buf, rows))
    dev_lib, n_lib = _device_ms(torch,
                                lambda: torch.index_select(view, 0, flat))
    h = np.asarray(h_rows).reshape(s, k)
    nbytes = sum(rows_bytes(h[i], np.zeros(k, np.uint8), n)['gather'][0]
                 for i in range(s))
    bound = nbytes / PEAK_BYTES * 1e3
    grid = gather_grid(torch, s, k, n)
    how = ('no launch query in this library' if grid is None else
           f'{grid["blocks"]} blocks ({grid["per_sm"]} resident an SM) x '
           f'{grid["run"]} B, segments of {grid["stage"]} B, ring of '
           f'{grid["stages"]} stages, {grid["smem"]} B shared')
    dev_s = 'not measured' if dev is None else f'{dev} ms ({n_dev} spans)'
    lib_s = 'not measured' if dev_lib is None else \
        f'{dev_lib} ms ({n_lib} spans)'
    share = '' if dev is None else f', device {bound / dev:.1%}'
    print(f'gather time {label}: S {s}, R {r}, K {k}, N {n}: kernel {ms} ms '
          f'(device {dev_s}), index_select {lib} ms (device {lib_s}); '
          f'bound {bound} ms ({nbytes / 1e6:.1f} MB), {bound / ms[0]:.1%} '
          f'of it by events{share}; {how}')
    return ms, lib


def rows_kernel_phase(torch, n: int, fails: list) -> list:
    """Kernels 11, 12, 15 and 16 at the quota-bounded shape: R = m + 1 =
    1001 buffer rows, the K = 124 rows and roles of round 2 of the m =
    1000 schedule, N = n, against their plain versions, each twice; then
    the gather at the main path's other shapes (``gather_times``)."""
    import numpy as np

    from repro_torch.core import protocol
    from repro_torch.kernels import ref
    from repro_torch.kernels.rows import gather_rows, scatter_rows
    from repro_torch.kernels.safa_aggregate import (
        safa_aggregate_packed_q8_rows, safa_aggregate_packed_rows)
    dev = torch.device('cuda')
    sched = scale_schedule(3)
    m = sched.m
    r = m + 1
    h_rows, h_roles = sched.idx[1], sched.roles[1]      # round 2
    k = len(h_rows)
    rows = torch.as_tensor(h_rows, device=dev)
    roles = torch.as_tensor(h_roles, device=dev)
    weights = torch.as_tensor(scale_spec().build().weights,
                              dtype=torch.float32, device=dev)
    w = protocol._slot_weights(rows, weights)
    # round 2's rows with a duplicate real row (slot 1 repeats slot 0's,
    # so slot 1 must win it) and two rows outside [0, R) that must land
    # in the scratch row R - 1
    h_dup = h_rows.copy()
    h_dup[1] = h_dup[0]
    h_dup[2], h_dup[3] = r + 7, -1
    dup_rows = torch.as_tensor(h_dup, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    cache0, trained, base, glob, agg = (normal(r, n), normal(k, n),
                                        normal(k, n), normal(n), normal(n))
    recs = []

    def check(cond, what):
        if not cond:
            fails.append(what)
            print(f'FAIL rows kernels: {what}')

    def vec_err(got, want, what):
        err = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
        check(all(torch.allclose(g, w_, rtol=1e-5, atol=1e-6)
                  for g, w_ in zip(got, want)),
              f'{what} new_global/new_agg beyond rtol 1e-5 / atol 1e-6 '
              f'(max abs err {err:.3e})')
        return err

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    real = h_rows < m
    need = rows_bytes(h_rows, h_roles, n)
    print(f'rows: K = {k} slots ({int(real.sum())} real) of R = {r} rows at '
          f'N = {n}; roles of round 2 of the m = {m} schedule')

    # -- gather_rows (kernel 11) -------------------------------------------
    got = gather_rows(cache0, rows)
    again = gather_rows(cache0, rows)
    dup = gather_rows(cache0, dup_rows)
    torch.cuda.synchronize()
    check(torch.equal(got, ref.gather_rows_ref(cache0, rows)),
          'gather_rows differs from its plain version')
    check(torch.equal(dup, ref.gather_rows_ref(cache0, dup_rows)),
          'gather_rows (duplicate and out-of-range rows) differs from its '
          'plain version')
    check(torch.equal(dup[1], cache0[int(h_dup[0])])
          and torch.equal(dup[2], cache0[r - 1])
          and torch.equal(dup[3], cache0[r - 1]),
          'gather_rows: an out-of-range row does not read the scratch row')
    check(torch.equal(got, again), 'gather_rows differs between launches')
    check(torch.equal(torch.index_select(cache0, 0, rows), got),
          'torch.index_select (the yardstick) differs')
    del got, again, dup
    ms, lib = gather_times(torch, f'm = {m} sparse_delta', cache0, rows,
                           h_rows, fails)
    plain = _time_ms(torch, lambda: ref.gather_rows_ref(cache0, rows),
                     warm=2, timed=10)
    recs.append(_record(
        'gather_rows', 'src/repro_torch/csrc/rows.cu',
        'src/repro/kernels/ops.py:270', 0.0, ms[0], plain, *need['gather'],
        library_ms=lib[0]))
    # every other shape the main path gives the gather
    for label, rr, h in gather_paper_shapes() + gather_tier_shapes():
        gather_times(torch, label, normal(rr, n),
                     torch.as_tensor(h, device=dev), h, fails)

    # -- scatter_rows (kernel 12), in place, last slot wins ------------------
    buf = cache0.clone()
    ptr = buf.data_ptr()
    out = scatter_rows(buf, rows, trained)
    want = ref.scatter_rows_ref(cache0.clone(), rows, trained)
    dup_buf = scatter_rows(cache0.clone(), dup_rows, trained)
    dup_want = ref.scatter_rows_ref(cache0.clone(), dup_rows, trained)
    twice = scatter_rows(cache0.clone(), dup_rows, trained)
    torch.cuda.synchronize()
    check(out.data_ptr() == ptr, 'scatter_rows not in place')
    check(torch.equal(out, want), 'scatter_rows differs from its plain '
                                  'version')
    check(torch.equal(dup_buf, dup_want), 'scatter_rows (duplicate rows) '
                                          'differs from its plain version')
    check(torch.equal(dup_buf[int(h_dup[0])], trained[1]),
          'scatter_rows: the last slot does not win its row')
    scratch_slot = int(np.flatnonzero((h_dup < 0) | (h_dup >= r - 1))[-1])
    check(torch.equal(dup_buf[r - 1], trained[scratch_slot]),
          'scatter_rows: an out-of-range row does not land in the scratch '
          'row')
    check(torch.equal(dup_buf, twice), 'scatter_rows differs between '
                                       'launches')
    ms = _time_ms(torch, lambda: scatter_rows(buf, rows, trained))
    plain = _time_ms(torch, lambda: ref.scatter_rows_ref(buf, rows, trained),
                     warm=2, timed=10)
    rows64 = rows.long()
    lib = _time_ms(torch, lambda: buf.index_copy_(0, rows64, trained))
    check(torch.equal(buf, want), 'index_copy_ (the yardstick) differs')
    recs.append(_record(
        'scatter_rows', 'src/repro_torch/csrc/rows.cu',
        'src/repro/kernels/ops.py:275', 0.0, ms, plain, *need['scatter'],
        library_ms=lib))
    del buf, out, want, dup_buf, dup_want, twice

    # -- safa_aggregate_packed_rows (kernel 15) -------------------------------
    args = (cache0, trained, glob, agg, rows, roles, w)
    want = ref.safa_aggregate_rows_ref(*args)
    got = safa_aggregate_packed_rows(*args)
    again = safa_aggregate_packed_rows(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]), 'safa_aggregate_packed_rows c2 '
                                        'differs')
    err = vec_err(got[:2], want[:2], 'safa_aggregate_packed_rows')
    check(same(got, again), 'safa_aggregate_packed_rows differs between '
                            'launches')
    ms = _time_ms(torch, lambda: safa_aggregate_packed_rows(*args))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_rows_ref(*args),
                     warm=2, timed=10)
    recs.append(_record(
        'safa_aggregate_packed_rows', 'src/repro_torch/csrc/safa_rows.cu',
        'src/repro/kernels/safa_aggregate.py:422', err, ms, plain,
        *need['rows']))

    # -- safa_aggregate_packed_q8_rows (kernel 16) ------------------------------
    q, sc = ref.quantize_packed_ref(trained)
    args = (q, sc, base, cache0, glob, agg, rows, roles, w)
    want = ref.safa_aggregate_q8_rows_ref(*args)
    got = safa_aggregate_packed_q8_rows(*args)
    again = safa_aggregate_packed_q8_rows(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
          'safa_aggregate_packed_q8_rows c2 or local rows differ')
    err = vec_err(got[:2], want[:2], 'safa_aggregate_packed_q8_rows')
    check(same(got, again), 'safa_aggregate_packed_q8_rows differs between '
                            'launches')
    ms = _time_ms(torch, lambda: safa_aggregate_packed_q8_rows(*args))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_q8_rows_ref(*args),
                     warm=2, timed=10)
    recs.append(_record(
        'safa_aggregate_packed_q8_rows', 'src/repro_torch/csrc/safa_rows.cu',
        'src/repro/kernels/safa_aggregate.py:507', err, ms, plain,
        *need['q8_rows']))
    _print_records(recs)
    return recs


def rows_fleet_kernel_phase(torch, n: int, fails: list) -> list:
    """Kernels 13, 14, 17 and 18 (the fleet forms of 11, 12, 15, 16) at
    S = 4 members of the quota-bounded shape: R = 1001 buffer rows, each
    member the rows and roles of round 2 of its own m = 1000 schedule
    (``scale_spec(s)``, env seeds 0-3, each with its own t_lim pin),
    padded to the fleet's widest K with sentinel slots as a sparse fleet
    schedule pads them; against the plain versions, bit for bit against
    the single-run kernel on every member's slices, each twice."""
    import numpy as np

    from repro_torch.core import protocol
    from repro_torch.core.schedules import SparseFleetSchedule
    from repro_torch.kernels import ref
    from repro_torch.kernels.rows import (gather_rows, gather_rows_fleet,
                                          scatter_rows, scatter_rows_fleet)
    from repro_torch.kernels.safa_aggregate import (
        safa_aggregate_packed_q8_rows, safa_aggregate_packed_q8_rows_fleet,
        safa_aggregate_packed_rows, safa_aggregate_packed_rows_fleet)
    dev = torch.device('cuda')
    fleet = SparseFleetSchedule.from_members(
        [scale_schedule(3, seed=s) for s in range(S)])
    m = fleet.m
    r = m + 1
    h_rows, h_roles = fleet.idx[:, 1], fleet.roles[:, 1]   # round 2
    k = h_rows.shape[1]
    rows = torch.as_tensor(h_rows, device=dev)
    roles = torch.as_tensor(h_roles, device=dev)
    weights = torch.as_tensor(
        np.stack([scale_spec(s).build().weights for s in range(S)]),
        dtype=torch.float32, device=dev)
    w = protocol._slot_weights(rows, weights)
    # every member's round-2 rows with a duplicate real row (slot 1 repeats
    # slot 0's) and two rows outside [0, R) that must land in the member's
    # own scratch row R - 1
    h_dup = h_rows.copy()
    h_dup[:, 1] = h_dup[:, 0]
    h_dup[:, 2], h_dup[:, 3] = r + 7, -1
    dup_rows = torch.as_tensor(h_dup, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    cache0, trained, base, glob, agg = (normal(S, r, n), normal(S, k, n),
                                        normal(S, k, n), normal(S, n),
                                        normal(S, n))
    recs = []

    def check(cond, what):
        if not cond:
            fails.append(what)
            print(f'FAIL rows fleet kernels: {what}')

    def vec_err(got, want, what):
        err = max((g - w_).abs().max().item() for g, w_ in zip(got, want))
        check(all(torch.allclose(g, w_, rtol=1e-5, atol=1e-6)
                  for g, w_ in zip(got, want)),
              f'{what} new_global/new_agg beyond rtol 1e-5 / atol 1e-6 '
              f'(max abs err {err:.3e})')
        return err

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def per_member(name, got, single):
        """Member s of the fleet launch against the single-run kernel on
        member s's slices, bit for bit."""
        for i in range(S):
            check(same([g[i] for g in got], single(i)),
                  f'{name} member {i} differs from the single-run kernel')

    def need(kind):
        per = [rows_bytes(h_rows[i], h_roles[i], n)[kind] for i in range(S)]
        return tuple(sum(x[j] for x in per) for j in range(3))

    caps = fleet.capacities.tolist()
    print(f'rows fleet: S = {S} members, K = {k} slots (members\' own K '
          f'{caps}; round 2: {(h_rows < m).sum(axis=1).tolist()} real) of '
          f'R = {r} rows at N = {n}')
    flat = (rows.long() + r * torch.arange(S, device=dev)[:, None]) \
        .reshape(-1)
    view = cache0.view(S * r, n)

    # -- gather_rows_fleet (kernel 13) ---------------------------------------
    got = gather_rows_fleet(cache0, rows)
    again = gather_rows_fleet(cache0, rows)
    dup = gather_rows_fleet(cache0, dup_rows)
    torch.cuda.synchronize()
    check(torch.equal(got, ref.gather_rows_ref(cache0, rows)),
          'gather_rows_fleet differs from its plain version')
    check(torch.equal(dup, ref.gather_rows_ref(cache0, dup_rows)),
          'gather_rows_fleet (duplicate and out-of-range rows) differs from '
          'its plain version')
    check(all(torch.equal(dup[i, 2], cache0[i, r - 1])
              and torch.equal(dup[i, 3], cache0[i, r - 1])
              for i in range(S)),
          'gather_rows_fleet: an out-of-range row does not read the '
          'member\'s scratch row')
    check(torch.equal(got, again), 'gather_rows_fleet differs between '
                                   'launches')
    per_member('gather_rows_fleet', (got,),
               lambda i: (gather_rows(cache0[i], rows[i]),))
    per_member('gather_rows_fleet (duplicate rows)', (dup,),
               lambda i: (gather_rows(cache0[i], dup_rows[i]),))
    check(torch.equal(torch.index_select(view, 0, flat).view(S, k, n), got),
          'torch.index_select (the yardstick) differs')
    del got, again, dup
    ms, lib = gather_times(torch, f'S = {S} sparse sweep', cache0, rows,
                           h_rows, fails)
    plain = _time_ms(torch, lambda: ref.gather_rows_ref(cache0, rows),
                     warm=2, timed=10)
    recs.append(_record(
        'gather_rows_fleet', 'src/repro_torch/csrc/rows.cu',
        'src/repro/kernels/ops.py:332', 0.0, ms[0], plain, *need('gather'),
        library_ms=lib[0]))

    # -- scatter_rows_fleet (kernel 14), in place, last slot wins ------------
    buf = cache0.clone()
    ptr = buf.data_ptr()
    out = scatter_rows_fleet(buf, rows, trained)
    want = ref.scatter_rows_ref(cache0.clone(), rows, trained)
    torch.cuda.synchronize()
    check(out.data_ptr() == ptr, 'scatter_rows_fleet not in place')
    check(torch.equal(out, want), 'scatter_rows_fleet differs from its '
                                  'plain version')
    del want
    per_member('scatter_rows_fleet', (out,),
               lambda i: (scatter_rows(cache0[i].clone(), rows[i],
                                       trained[i]),))
    dup_buf = scatter_rows_fleet(cache0.clone(), dup_rows, trained)
    dup_want = ref.scatter_rows_ref(cache0.clone(), dup_rows, trained)
    torch.cuda.synchronize()
    check(torch.equal(dup_buf, dup_want), 'scatter_rows_fleet (duplicate '
                                          'rows) differs from its plain '
                                          'version')
    del dup_want
    check(all(torch.equal(dup_buf[i, int(h_dup[i, 0])], trained[i, 1])
              for i in range(S)),
          'scatter_rows_fleet: the last slot does not win its row')
    last_out = [int(np.flatnonzero((h_dup[i] < 0) | (h_dup[i] >= r - 1))[-1])
                for i in range(S)]
    check(all(torch.equal(dup_buf[i, r - 1], trained[i, last_out[i]])
              for i in range(S)),
          'scatter_rows_fleet: an out-of-range row does not land in the '
          'member\'s scratch row')
    per_member('scatter_rows_fleet (duplicate rows)', (dup_buf,),
               lambda i: (scatter_rows(cache0[i].clone(), dup_rows[i],
                                       trained[i]),))
    twice = scatter_rows_fleet(cache0.clone(), dup_rows, trained)
    torch.cuda.synchronize()
    check(torch.equal(dup_buf, twice), 'scatter_rows_fleet differs between '
                                       'launches')
    del dup_buf, twice
    ms = _time_ms(torch, lambda: scatter_rows_fleet(buf, rows, trained))
    plain = _time_ms(torch, lambda: ref.scatter_rows_ref(buf, rows, trained),
                     warm=2, timed=10)
    lib = _time_ms(torch, lambda: buf.view(S * r, n).index_copy_(
        0, flat, trained.view(S * k, n)))
    # index_copy_ leaves a row that several slots share to any of them:
    # only the sentinel slots share one, each member's scratch row
    check(torch.equal(buf[:, :r - 1], out[:, :r - 1]),
          'index_copy_ (the yardstick) differs')
    recs.append(_record(
        'scatter_rows_fleet', 'src/repro_torch/csrc/rows.cu',
        'src/repro/kernels/ops.py:337', 0.0, ms, plain, *need('scatter'),
        library_ms=lib))
    del buf, out

    # -- safa_aggregate_packed_rows_fleet (kernel 17) ------------------------
    args = (cache0, trained, glob, agg, rows, roles, w)
    want = ref.safa_aggregate_rows_ref(*args)
    got = safa_aggregate_packed_rows_fleet(*args)
    again = safa_aggregate_packed_rows_fleet(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]), 'safa_aggregate_packed_rows_fleet '
                                        'c2 differs')
    err = vec_err(got[:2], want[:2], 'safa_aggregate_packed_rows_fleet')
    check(same(got, again), 'safa_aggregate_packed_rows_fleet differs '
                            'between launches')
    per_member('safa_aggregate_packed_rows_fleet', got,
               lambda i: safa_aggregate_packed_rows(*(a[i] for a in args)))
    ms = _time_ms(torch, lambda: safa_aggregate_packed_rows_fleet(*args))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_rows_ref(*args),
                     warm=2, timed=10)
    recs.append(_record(
        'safa_aggregate_packed_rows_fleet',
        'src/repro_torch/csrc/safa_rows.cu',
        'src/repro/kernels/safa_aggregate.py:600', err, ms, plain,
        *need('rows')))
    del want, got, again

    # -- safa_aggregate_packed_q8_rows_fleet (kernel 18) ---------------------
    q, sc = ref.quantize_packed_ref(trained)
    args = (q, sc, base, cache0, glob, agg, rows, roles, w)
    want = ref.safa_aggregate_q8_rows_ref(*args)
    got = safa_aggregate_packed_q8_rows_fleet(*args)
    again = safa_aggregate_packed_q8_rows_fleet(*args)
    torch.cuda.synchronize()
    check(torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]),
          'safa_aggregate_packed_q8_rows_fleet c2 or local rows differ')
    err = vec_err(got[:2], want[:2], 'safa_aggregate_packed_q8_rows_fleet')
    check(same(got, again), 'safa_aggregate_packed_q8_rows_fleet differs '
                            'between launches')
    per_member('safa_aggregate_packed_q8_rows_fleet', got,
               lambda i: safa_aggregate_packed_q8_rows(
                   *(a[i] for a in args)))
    ms = _time_ms(torch, lambda: safa_aggregate_packed_q8_rows_fleet(*args))
    plain = _time_ms(torch, lambda: ref.safa_aggregate_q8_rows_ref(*args),
                     warm=2, timed=10)
    recs.append(_record(
        'safa_aggregate_packed_q8_rows_fleet',
        'src/repro_torch/csrc/safa_rows.cu',
        'src/repro/kernels/safa_aggregate.py:678', err, ms, plain,
        *need('q8_rows')))
    _print_records(recs)
    return recs


def cnn_setup(torch, spec=None):
    """Task 2's CNN on the card at full width: (EnvSpec, task), on the
    paper's environment unless ``spec`` names another."""
    from repro_torch.configs import PAPER_TASKS
    from repro_torch.data import make_images, partition
    from repro_torch.data.tasks import cnn_task
    from repro_torch.fedsim import EnvSpec

    cfg = PAPER_TASKS['task2_cnn']
    if spec is None:
        spec = EnvSpec(m=cfg['m'], crash_prob=0.3,
                       dataset_size=cfg['dataset_size'],
                       batch_size=cfg['batch_size'], epochs=cfg['epochs'],
                       t_lim=cfg['t_lim'], seed=0)
    t0 = time.perf_counter()
    x, y = make_images(n=spec.dataset_size, seed=0)
    data = partition(x, y, spec.build().partition_sizes, spec.batch_size,
                     seed=0)
    task = cnn_task(data, lr=1e-3, epochs=cfg['epochs'])
    print(f'setup: data {tuple(data.x.shape)} made in '
          f'{time.perf_counter() - t0:.1f} s')
    return spec, task


def _counted(fn, calls: dict, key: str):
    """``fn`` with its calls counted in ``calls[key]``."""
    def wrapper(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)
    return wrapper


def _timed(torch, fn, into):
    """``fn`` with the host seconds of each call (synchronised on both
    sides) appended to ``into``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t)
        return out
    return wrapper


def main_path_phase(torch, spec, task, fails: list) -> dict:
    """Task 2's CNN through the port's entry points; returns the launch
    counts of each kernel in the run that drives it."""
    import numpy as np

    from repro_torch import api
    from repro_torch.core import protocol
    from repro_torch.kernels import backend

    init_loss = task.evaluate(task.init_global(0))['loss']
    print(f'main: initial eval loss {init_loss:.6f}; rounds {ROUNDS} '
          f'(not cut)')
    train_s, server_s = [], []
    launches, finals = {}, {}
    runs = [('packed', dict(use_kernel='packed'),
             ('safa_aggregate_packed',)),
            ('int8', dict(wire='int8'),
             ('quantize_packed', 'safa_aggregate_packed_q8')),
            ('plain', dict(use_kernel=False), ())]
    server_step = protocol.safa_server_step
    for name, ex, kernels in runs:
        exp = api.Experiment(task, spec, api.SafaSpec(fraction=0.3,
                                                      lag_tolerance=5),
                             api.ExecSpec(eval_every=ROUNDS, **ex),
                             rounds=ROUNDS)
        train_s.clear()
        server_s.clear()
        task.local_train = _timed(torch, task.local_train, train_s)
        protocol.safa_server_step = _timed(torch, server_step, server_s)
        try:
            backend.reset_launches()
            t = time.perf_counter()
            hist = exp.compile().run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = dict(backend.LAUNCHES)
        finally:
            protocol.safa_server_step = server_step
            del task.local_train
        losses = [e['loss'] for _, e in hist.evals()]
        print(f'main[{name}]: {wall:.2f} s for {ROUNDS} rounds; per round '
              f'train {[round(s, 4) for s in train_s]} s, server step '
              f'{[round(s, 4) for s in server_s]} s; launches {counts}; '
              f'eval losses {losses}')
        for k in kernels:
            launches[k] = counts[k]
            if counts[k] != ROUNDS:
                fails.append(f'{name}: {k} launched {counts[k]} times in '
                             f'{ROUNDS} rounds')
        others = {k: v for k, v in counts.items() if k not in kernels and v}
        if others:
            fails.append(f'{name}: unexpected launches {others}')
        if not all(np.isfinite(v) for v in losses) or \
                not losses[-1] < init_loss:
            fails.append(f'{name}: eval losses {losses} not finite and below '
                         f'the initial {init_loss}')
        finals[name] = hist.final_global

    diff = max((finals['packed'][k] - finals['plain'][k]).abs().max().item()
               for k in finals['plain'])
    print(f'main: packed vs plain final_global max abs diff {diff:.3e}')
    if not diff <= 1e-4:
        fails.append(f'packed vs plain final_global differ by {diff:.3e}')
    one = one_epoch(task)
    profile_train(torch, 'profile (one epoch)', lambda: one.local_train(
        protocol.broadcast_global(task.init_global(0), spec.m), 0))
    return launches


def quantize_uploads_phase(torch, spec, task, fails: list) -> dict:
    """The per-leaf int8 reference (``SafaSpec(quantize_uploads=True)``)
    on Task 2's CNN at full width through ``run()``: with
    ``use_kernel='packed'`` and plain, beside the ``wire='int8'`` run it
    is the ground truth of.  Trains with deterministic cuDNN, as the
    weighted phase does, so that the packed run and the int8 wire train
    the same bits; returns the launch counts of kernels 5 and 6 in the
    packed run."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _quantize_uploads_runs(torch, spec, task, fails)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _quantize_uploads_runs(torch, spec, task, fails: list) -> dict:
    from repro_torch import api
    from repro_torch.core import federation, protocol
    from repro_torch.kernels import backend

    rounds = ROUNDS
    init_loss = task.evaluate(task.init_global(0))['loss']
    per_leaf = rounds * spec.m * len(CNN_LEAVES)
    print(f'quantize_uploads: {_card_line()}; initial eval loss '
          f'{init_loss:.6f}; rounds {rounds}; {per_leaf} launches of each '
          f'leaf kernel expected')
    runs = [('per-leaf packed', True, dict(use_kernel='packed'),
             {'quantize': per_leaf, 'dequantize': per_leaf,
              'safa_aggregate_packed': rounds}),
            ('per-leaf plain', True, {},
             {'quantize': per_leaf, 'dequantize': per_leaf}),
            ('int8 wire', False, dict(wire='int8', use_kernel='packed'),
             {'quantize_packed': rounds,
              'safa_aggregate_packed_q8': rounds})]
    wrap, server_step = federation._quantized_train_fn, \
        protocol.safa_server_step
    entries = {k: getattr(federation, k)
               for k in ('quantize_rows', 'dequantize_rows')}
    hists, launches = {}, {}
    for name, knob, ex, want in runs:
        exp = api.Experiment(task, spec,
                             api.SafaSpec(fraction=0.3, lag_tolerance=5,
                                          quantize_uploads=knob),
                             api.ExecSpec(eval_every=1, **ex), rounds=rounds)
        train_s, trip_s, server_s = [], [], []
        calls = dict.fromkeys(entries, 0)
        task.local_train = _timed(torch, task.local_train, train_s)
        federation._quantized_train_fn = \
            lambda base: _timed(torch, wrap(base), trip_s)
        protocol.safa_server_step = _timed(torch, server_step, server_s)
        for k, fn in entries.items():
            setattr(federation, k, _counted(fn, calls, k))
        try:
            backend.reset_launches()
            t = time.perf_counter()
            hist = exp.compile().run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = {k: v for k, v in backend.LAUNCHES.items() if v}
        finally:
            federation._quantized_train_fn = wrap
            protocol.safa_server_step = server_step
            for k, fn in entries.items():
                setattr(federation, k, fn)
            del task.local_train
        trip = [round(a - b, 4) for a, b in zip(trip_s, train_s)]
        print(f'quantize_uploads[{name}]: {wall:.2f} s for {rounds} rounds; '
              f'per round train {[round(v, 4) for v in train_s]} s, round '
              f'trip {trip or "none"} s, server step '
              f'{[round(v, 4) for v in server_s]} s; launches {counts}; '
              f'host calls {calls}')
        if counts != want:
            fails.append(f'quantize_uploads[{name}]: launches {counts}, '
                         f'want {want}')
        want_calls = rounds * len(CNN_LEAVES) if knob else 0
        if calls != dict.fromkeys(entries, want_calls):
            fails.append(f'quantize_uploads[{name}]: host calls {calls}, '
                         f'want {want_calls} of each (one a leaf a round)')
        _check_losses(f'quantize_uploads[{name}]',
                      [e['loss'] for _, e in hist.evals()], init_loss, fails)
        hists[name] = hist
        if name == 'per-leaf packed':
            launches = {k: counts.get(k, 0)
                        for k in ('quantize', 'dequantize')}
    ref, wire = hists['per-leaf packed'], hists['int8 wire']
    same = ref.evals() == wire.evals() and all(
        torch.equal(v, wire.final_global[k])
        for k, v in ref.final_global.items())
    print(f'quantize_uploads: per-leaf packed vs int8 wire, every eval and '
          f'final_global bit for bit: {same} (max abs diff '
          f'{_max_diff(ref.final_global, wire.final_global):.3e})')
    if not same:
        fails.append('quantize_uploads: the per-leaf packed run differs from '
                     'the int8 wire run')
    # plain and packed sum the clients in another order; an int8 rounding
    # edge turns that into a whole quantisation step of a weight, as the
    # sparse phase holds its int8 pairs after two rounds
    diff = _max_diff(hists['per-leaf plain'].final_global, ref.final_global)
    step = max(v.abs().max().item() for v in ref.final_global.values()) / 127
    print(f'quantize_uploads: per-leaf plain vs packed final_global max abs '
          f'diff {diff:.3e}, one quantisation step (max |w| / 127) '
          f'{step:.3e}')
    if not diff <= step:
        fails.append(f'quantize_uploads: per-leaf plain vs packed differ by '
                     f'{diff:.3e}, beyond one quantisation step {step:.3e}')
    return launches


def fleet_path_phase(torch, spec, task, fails: list) -> dict:
    """A 4-member sweep of Task 2's CNN at full width through
    ``run_sweep``; returns the launch counts of each fleet kernel in the
    run that drives it."""
    import numpy as np

    from repro_torch import api
    from repro_torch.core import protocol
    from repro_torch.kernels import backend

    init_loss = [task.evaluate(task.init_global(s))['loss']
                 for s in range(S)]
    print(f'fleet: {S} members, crash rates {FLEET_CRASH}, initial eval '
          f'losses {init_loss}; rounds {FLEET_ROUNDS}')

    def members():
        return [api.SweepMember(env=spec, fraction=0.3, lag_tolerance=5,
                                seed=s, overrides={'crash_prob': cr})
                for s, cr in enumerate(FLEET_CRASH)]

    train_s, server_s = [], []
    launches, finals = {}, {}
    runs = [('packed', dict(use_kernel='packed'),
             ('safa_aggregate_packed_fleet',)),
            ('int8', dict(wire='int8'),
             ('quantize_packed_fleet', 'safa_aggregate_packed_q8_fleet')),
            ('plain', dict(use_kernel=False), ())]
    server_step = protocol.safa_server_step
    for name, ex, kernels in runs:
        exp = api.Experiment(task, None, api.SafaSpec(),
                             api.ExecSpec(eval_every=FLEET_ROUNDS, **ex),
                             rounds=FLEET_ROUNDS)
        train_s.clear()
        server_s.clear()
        task.local_train_fleet = _timed(torch, task.local_train_fleet,
                                        train_s)
        protocol.safa_server_step = _timed(torch, server_step, server_s)
        try:
            backend.reset_launches()
            t = time.perf_counter()
            hists = exp.compile().run_sweep(members())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts = dict(backend.LAUNCHES)
        finally:
            protocol.safa_server_step = server_step
            del task.local_train_fleet
        losses = [[e['loss'] for _, e in h.evals()] for h in hists]
        print(f'fleet[{name}]: {wall:.2f} s for {FLEET_ROUNDS} rounds of '
              f'{S} members; per fleet round train '
              f'{[round(v, 4) for v in train_s]} s, server step '
              f'{[round(v, 4) for v in server_s]} s; launches {counts}; '
              f'eval losses per member {losses}')
        for k in kernels:
            launches[k] = counts[k]
            if counts[k] != FLEET_ROUNDS:
                fails.append(f'fleet {name}: {k} launched {counts[k]} times '
                             f'in {FLEET_ROUNDS} rounds')
        others = {k: v for k, v in counts.items() if k not in kernels and v}
        if others:
            fails.append(f'fleet {name}: unexpected launches {others}')
        for s, ls in enumerate(losses):
            if not all(np.isfinite(v) for v in ls) or \
                    not ls[-1] < init_loss[s]:
                fails.append(f'fleet {name}: member {s} eval losses {ls} '
                             f'not finite and below the initial '
                             f'{init_loss[s]}')
        finals[name] = [h.final_global for h in hists]

    diffs = [max((finals['packed'][s][k] - finals['plain'][s][k])
                 .abs().max().item() for k in finals['plain'][s])
             for s in range(S)]
    print(f'fleet: packed vs plain final_global max abs diff per member '
          f'{diffs}')
    if not max(diffs) <= 1e-4:
        fails.append(f'fleet: packed vs plain final_global differ by '
                     f'{diffs}')
    g = api.init_fleet_global(task, list(range(S)))
    one = one_epoch(task)
    profile_train(torch, 'fleet profile (one epoch)',
                  lambda: one.local_train_fleet(
                      protocol.broadcast_global(g, spec.m, fleet=True),
                      None))
    return launches


def _drive(torch, task, label, steps, kernels, rounds, go, fleet, fails):
    """Run ``go()`` once, every launch counter set to 0 just before, with
    the task's local training and the ``core.protocol`` server steps named
    in ``steps`` timed per call; print the per-round seconds and the
    launches, and fail unless each kernel in ``kernels`` launched once per
    round and no other kernel launched.  Returns (go's result, counts)."""
    from repro_torch.core import protocol
    from repro_torch.kernels import backend

    originals = {k: getattr(protocol, k) for k in steps}
    train_s, server_s = [], []
    attr = 'local_train_fleet' if fleet else 'local_train'
    setattr(task, attr, _timed(torch, getattr(task, attr), train_s))
    for k in steps:
        setattr(protocol, k, _timed(torch, originals[k], server_s))
    try:
        backend.reset_launches()
        t = time.perf_counter()
        out = go()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(backend.LAUNCHES)
    finally:
        for k in steps:
            setattr(protocol, k, originals[k])
        delattr(task, attr)
    print(f'{label}: {wall:.2f} s for {rounds} rounds; per round train '
          f'{[round(v, 4) for v in train_s]} s, server step '
          f'{[round(v, 4) for v in server_s]} s; launches '
          f'{ {k: v for k, v in counts.items() if v} }')
    for k in kernels:
        if counts[k] != rounds:
            fails.append(f'{label}: {k} launched {counts[k]} times in '
                         f'{rounds} rounds')
    others = {k: v for k, v in counts.items() if k not in kernels and v}
    if others:
        fails.append(f'{label}: unexpected launches {others}')
    return out, counts


def _check_losses(label, losses, init, fails):
    print(f'{label}: eval losses {losses}')
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < init:
        fails.append(f'{label}: eval losses {losses} not finite and below '
                     f'the initial {init}')


def _fingerprint(tree: dict) -> str:
    """The first 16 hex digits of the sha256 of a model's leaves' bytes,
    in key order: two runs that print the same ended on the same bits."""
    import hashlib
    h = hashlib.sha256()
    for key in sorted(tree):
        h.update(key.encode())
        h.update(tree[key].detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _max_diff(a: dict, b: dict) -> float:
    return max((a[k] - b[k]).abs().max().item() for k in b)


def baselines_phase(torch, spec, task, fails: list) -> dict:
    """The paper's baselines on Task 2's CNN at full width through the
    port's entry points: single runs of every baseline cell, then a
    4-member FedAvg int8 sweep; returns the launch counts of the
    dequantisation kernels in the runs that drive them."""
    from repro_torch import api

    init_loss = [task.evaluate(task.init_global(s))['loss']
                 for s in range(S)]
    print(f'baselines: initial eval losses {init_loss}; rounds '
          f'{BASE_ROUNDS}, C = 0.3')
    wire = ('quantize_packed', 'dequantize_packed')
    runs = [('fedavg-int8', api.FedAvgSpec(fraction=0.3), 'int8', wire),
            ('fedcs-int8', api.FedCSSpec(fraction=0.3), 'int8', wire),
            ('fedavg', api.FedAvgSpec(fraction=0.3), 'f32', ()),
            ('local', api.LocalSpec(fraction=0.3), 'f32', ()),
            ('fedasync', api.FedAsyncSpec(), 'f32', ())]
    # the server step of each protocol, timed where its round calls it
    steps = ('fedavg_server_step', 'fedasync_merge')
    launches = {'dequantize_packed': 0, 'dequantize_packed_fleet': 0}
    finals = {}

    def drive(name, kernels, rounds, go, fleet):
        out, counts = _drive(torch, task, f'baselines[{name}]', steps,
                             kernels, rounds, go, fleet, fails)
        for k in kernels:
            if k in launches:
                launches[k] += counts[k]
        return out

    def check_losses(name, losses, init):
        _check_losses(f'baselines[{name}]', losses, init, fails)

    for name, sp, wire_kind, kernels in runs:
        exp = api.Experiment(task, spec, sp,
                             api.ExecSpec(eval_every=BASE_ROUNDS,
                                          wire=wire_kind),
                             rounds=BASE_ROUNDS)
        hist = drive(name, kernels, BASE_ROUNDS, exp.compile().run, False)
        check_losses(name, [e['loss'] for _, e in hist.evals()],
                     init_loss[0])
        finals[name] = hist.final_global

    # int8 against f32 on the same schedule: each round the wire moves an
    # upload by at most half its block's step (amax / 254); the renormalised
    # average moves the global by no more, and the next round's training
    # carries it on.  Bound: one step of the largest weight per round.
    amax = max(v.abs().max().item() for v in finals['fedavg'].values())
    bound = BASE_ROUNDS * amax / 127
    diff = _max_diff(finals['fedavg-int8'], finals['fedavg'])
    print(f'baselines: FedAvg int8 vs f32 final_global max abs diff '
          f'{diff:.3e}, bound {bound:.3e} (rounds x max |w| / 127)')
    if not diff <= bound:
        fails.append(f'baselines: FedAvg int8 vs f32 differ by {diff:.3e} '
                     f'> {bound:.3e}')

    members = [api.SweepMember(env=spec, fraction=0.3, seed=s,
                               overrides={'crash_prob': cr})
               for s, cr in enumerate(FLEET_CRASH)]
    exp = api.Experiment(task, None, api.FedAvgSpec(),
                         api.ExecSpec(eval_every=BASE_ROUNDS, wire='int8'),
                         rounds=BASE_ROUNDS)
    hists = drive('fedavg-int8 sweep', tuple(k + '_fleet' for k in wire),
                  BASE_ROUNDS, lambda: exp.compile().run_sweep(members),
                  True)
    for s, h in enumerate(hists):
        check_losses(f'fedavg-int8 sweep member {s}',
                     [e['loss'] for _, e in h.evals()], init_loss[s])
    return launches


#: every round function of the SAFA and FedAvg/FedCS engines, timed whole
#: in the sparse phase: a round's server step is the round less its
#: training
ROUND_FNS = ('safa_round', 'safa_round_sparse', 'safa_round_sparse_delta',
             'safa_round_sparse_delta_packed', 'safa_round_sparse_tier',
             'safa_round_sparse_tier_packed', 'fedavg_round',
             'fedavg_round_sparse', 'fedavg_round_sparse_delta')
#: FedCS ``sparse_delta`` against dense after two rounds.  The stateless
#: form carries the global alone, so its whole algebra is held within
#: 1e-5 after one round; its second round trains from a global that the
#: first round's summation order moved by ~1e-7, and a round of training
#: carries that ~100-fold (the phase's control prints it).
STATELESS_TOL = 1e-4
#: the packed sparse_delta round's launches, f32 and int8
DELTA_PACKED = {'gather_rows': 1, 'safa_aggregate_packed_rows': 1,
                'scatter_rows': 2}
DELTA_PACKED_Q8 = {'gather_rows': 1, 'quantize_packed': 1,
                   'safa_aggregate_packed_q8_rows': 1, 'scatter_rows': 2}


def sparse_phase(torch, spec, task, fails: list) -> dict:
    """The sparse schedules on Task 2's CNN at full width through
    ``run()``, on the paper's environment and on the quota-bounded one;
    returns the launch counts of kernels 11, 12, 15 and 16 in the runs
    that drive them.  Trains with deterministic cuDNN, as the weighted
    phase does, so that the 1e-5 checks measure the port and not cuDNN's
    run-to-run noise."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _sparse_runs(torch, spec, task, fails)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _drive_run(torch, task, label, exp, kernels, fails):
    """One ``run()`` with every launch counter at 0 before it, its local
    training and its round functions timed per call and the peak device
    memory reset before it; fails unless each kernel in ``kernels``
    launched its count per round and no other kernel launched.  Returns
    the History."""
    from repro_torch.core import protocol
    from repro_torch.kernels import backend

    rounds = exp.rounds
    sched = exp.precompute()
    tier = exp.exec.schedule == 'sparse_tier'
    k = sched.width if tier else getattr(sched, 'capacity', exp.env.m)
    originals = {f: getattr(protocol, f) for f in ROUND_FNS}
    attr = 'local_train' if exp.exec.schedule == 'dense' \
        else 'local_train_rows'
    train_s, round_s = [], []
    setattr(task, attr, _timed(torch, getattr(task, attr), train_s))
    for f in ROUND_FNS:
        setattr(protocol, f, _timed(torch, originals[f], round_s))
    try:
        backend.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        hist = exp.compile().run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        counts = {c: v for c, v in backend.LAUNCHES.items() if v}
    finally:
        for f in ROUND_FNS:
            setattr(protocol, f, originals[f])
        delattr(task, attr)
    server_s = [r - t for r, t in zip(round_s, train_s)]
    cap = f', tier capacity {sched.capacity}' if tier else ''
    print(f'{label}: K {k} of m {exp.env.m}{cap}; {wall:.2f} s for {rounds} '
          f'rounds; per round train {[round(v, 4) for v in train_s]} s, '
          f'server step {[round(v, 4) for v in server_s]} s; launches '
          f'{counts}; peak device memory {peak / 2**30:.3f} GiB')
    print(f'{label}: final_global sha256 {_fingerprint(hist.final_global)}')
    want = {c: n * rounds for c, n in kernels.items()}
    if counts != want:
        fails.append(f'{label}: launches {counts}, want {want}')
    hist.peak = peak
    return hist


def _sparse_runs(torch, spec, task, fails: list) -> dict:
    from repro_torch import api

    rounds = SPARSE_ROUNDS
    safa = api.SafaSpec(fraction=0.3, lag_tolerance=5)
    q8 = {'quantize_packed': 1, 'safa_aggregate_packed_q8': 1}
    wire = {'quantize_packed': 1, 'dequantize_packed': 1}
    # (label, spec, exec fields, launches per round)
    paper = [
        ('safa-sparse-packed', safa,
         dict(schedule='sparse', use_kernel='packed'),
         {'safa_aggregate_packed': 1}),
        ('safa-sparse-int8', safa, dict(schedule='sparse', wire='int8'), q8),
        ('safa-delta-packed', safa,
         dict(schedule='sparse_delta', use_kernel='packed'), DELTA_PACKED),
        ('safa-delta-packed-int8', safa,
         dict(schedule='sparse_delta', use_kernel='packed', wire='int8'),
         DELTA_PACKED_Q8),
        ('safa-delta-plain', safa, dict(schedule='sparse_delta'), {}),
        ('safa-dense-packed', safa, dict(use_kernel='packed'),
         {'safa_aggregate_packed': 1}),
        ('safa-dense-int8', safa, dict(wire='int8'), q8),
        ('fedavg-sparse', api.FedAvgSpec(fraction=0.3),
         dict(schedule='sparse'), {}),
        ('fedavg-delta-int8', api.FedAvgSpec(fraction=0.3),
         dict(schedule='sparse_delta', wire='int8'), wire),
        ('fedcs-delta', api.FedCSSpec(fraction=0.3),
         dict(schedule='sparse_delta'), {}),
        ('fedcs-dense', api.FedCSSpec(fraction=0.3), {}, {}),
        ('fedavg-dense', api.FedAvgSpec(fraction=0.3), {}, {}),
        ('fedavg-dense-int8', api.FedAvgSpec(fraction=0.3),
         dict(wire='int8'), wire),
    ]
    # f32: (run, its reference) within 1e-5
    # f32: (run, its reference, tolerance after all rounds); every pair is
    # held within 1e-5 after one round
    paper_f32 = [('safa-sparse-packed', 'safa-dense-packed', 1e-5),
                 ('safa-delta-packed', 'safa-delta-plain', 1e-5),
                 ('safa-delta-plain', 'safa-dense-packed', 1e-5),
                 ('fedavg-sparse', 'fedavg-dense', 1e-5),
                 ('fedcs-delta', 'fedcs-dense', STATELESS_TOL)]
    # int8: (run, the int8 dense run)
    paper_q8 = [('safa-sparse-int8', 'safa-dense-int8'),
                ('safa-delta-packed-int8', 'safa-dense-int8'),
                ('fedavg-delta-int8', 'fedavg-dense-int8')]
    scale = api.SafaSpec(fraction=QUOTA / SCALE_M,
                         lag_tolerance=10 * rounds)
    quota = [
        ('scale-dense-packed', scale, dict(use_kernel='packed'),
         {'safa_aggregate_packed': 1}),
        ('scale-delta-packed', scale,
         dict(schedule='sparse_delta', use_kernel='packed'), DELTA_PACKED),
        ('scale-dense-int8', scale, dict(wire='int8'), q8),
        ('scale-delta-packed-int8', scale,
         dict(schedule='sparse_delta', use_kernel='packed', wire='int8'),
         DELTA_PACKED_Q8),
    ]
    launches = {}

    def run_all(env_spec, env_task, runs, n_rounds, init):
        finals = {}
        for label, sp, ex, kernels in runs:
            tag = f'sparse[{label}, {n_rounds} round{"s" * (n_rounds > 1)}]'
            exp = api.Experiment(env_task, env_spec, sp,
                                 api.ExecSpec(eval_every=n_rounds, **ex),
                                 rounds=n_rounds)
            hist = _drive_run(torch, env_task, tag, exp, kernels, fails)
            _check_losses(tag, [e['loss'] for _, e in hist.evals()], init,
                          fails)
            finals[label] = hist.final_global
            if n_rounds == rounds and label in ('safa-delta-packed',
                                                'safa-delta-packed-int8'):
                from repro_torch.kernels import backend
                for c in kernels:
                    if c != 'quantize_packed':
                        launches[c] = backend.LAUNCHES[c]
        return finals

    def drive(env_spec, env_task, runs, f32_pairs, q8_pairs):
        init = env_task.evaluate(env_task.init_global(0))['loss']
        print(f'sparse: m = {env_spec.m}, initial eval loss {init:.6f}; '
              f'rounds {rounds}')
        finals = run_all(env_spec, env_task, runs, rounds, init)
        labels = {x for pair in f32_pairs + q8_pairs for x in pair[:2]}
        first = run_all(env_spec, env_task,
                        [r for r in runs if r[0] in labels], 1, init)
        for run, ref, tol in f32_pairs:
            one = _max_diff(first[run], first[ref])
            diff = _max_diff(finals[run], finals[ref])
            print(f'sparse: {run} vs {ref} final_global max abs diff after '
                  f'1 round {one:.3e} (tolerance 1e-05), after {rounds} '
                  f'rounds {diff:.3e} (tolerance {tol:.0e})')
            if not (one <= 1e-5 and diff <= tol):
                fails.append(f'sparse: {run} vs {ref} differ by {one:.3e} '
                             f'after 1 round, {diff:.3e} after {rounds}')
        # int8 against the int8 dense run.  After one round the two differ
        # only by the aggregation's summation order (the uploads are the
        # same bits), and 1e-4 holds.  From the second round on, that
        # rounding can move a trained value across an int8 rounding edge,
        # and its upload then moves by a whole quantisation step (its
        # block's amax / 127, times the client's weight, and the weights
        # sum to at most 1): the run is held to one step of the model's
        # largest weight.
        for run, ref in q8_pairs:
            one = _max_diff(first[run], first[ref])
            diff = _max_diff(finals[run], finals[ref])
            amax = max(v.abs().max().item() for v in finals[ref].values())
            bound = amax / 127
            beyond = sum(int(((finals[run][k] - v).abs() > 1e-4).sum())
                         for k, v in finals[ref].items())
            print(f'sparse: {run} vs {ref} final_global max abs diff after '
                  f'1 round {one:.3e} (tolerance 1e-04), after {rounds} '
                  f'rounds {diff:.3e} ({beyond} values beyond 1e-4; bound '
                  f'{bound:.3e} = max |w| / 127)')
            if not (one <= 1e-4 and diff <= bound):
                fails.append(f'sparse: {run} vs {ref} differ by {one:.3e} '
                             f'after 1 round, {diff:.3e} after {rounds}')
        return first

    first = drive(spec, task, paper, paper_f32, paper_q8)
    # The stateless form's control: FedCS's dense round 1 again, once from
    # the dense run's round-1 global and once from the sparse_delta run's;
    # the gap is how far one round of training carries the round-1
    # summation-order difference, which is all the two runs' second
    # rounds differ by.
    starts = [{k: v.cpu().numpy() for k, v in first[label].items()}
              for label in ('fedcs-dense', 'fedcs-delta')]
    carried = [api.Experiment(task, spec, api.FedCSSpec(fraction=0.3),
                              api.ExecSpec(eval_every=1), rounds=1,
                              init_params=g).compile().run().final_global
               for g in starts]
    print(f'sparse: control: FedCS dense round 1 from the dense vs the '
          f'sparse_delta round-1 global: final_global max abs diff '
          f'{_max_diff(carried[1], carried[0]):.3e} (from '
          f'{_max_diff(first["fedcs-delta"], first["fedcs-dense"]):.3e})')
    del first, starts, carried
    scale_env, scale_task = cnn_setup(torch, scale_spec())
    drive(scale_env, scale_task, quota,
          [('scale-delta-packed', 'scale-dense-packed', 1e-5)],
          [('scale-delta-packed-int8', 'scale-dense-int8')])
    del scale_task
    torch.cuda.empty_cache()
    return launches


def sparse_sweep_phase(torch, spec, task, fails: list) -> dict:
    """Sparse sweeps of Task 2's CNN at full width through ``run_sweep``,
    on the fleet and the sequential engine, on the paper's environment
    (m = 100) and on the quota-bounded one (m = 1000); returns the launch
    counts of kernels 13, 14, 17 and 18 in the fleet runs that drive
    them.  Trains with deterministic cuDNN, as the sparse phase does."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _sparse_sweeps(torch, spec, task, fails)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _fleet_forms(kernels: dict) -> dict:
    """A single run's launches per round -> a fleet's per fleet round: the
    fleet form of every kernel, as often."""
    return {k + '_fleet': v for k, v in kernels.items()}


def _capacities(exp, members) -> list:
    """Every member's own active-set width K on ``exp``'s sparse (or
    lag-tier: the same events) schedule (host precompute only)."""
    import dataclasses

    from repro_torch import api
    built = [dataclasses.replace(
        mem, env=mem.env.replace(**(mem.overrides or {})).build(),
        overrides=None) for mem in members]
    pdef = api.PROTOCOLS[type(exp.protocol)]
    fleet = pdef.fleet_precompute(built, exp.protocol,
                                  rounds=exp.rounds).to_sparse()
    return fleet.capacities.tolist()


def _tier_capacity(exp, members) -> int:
    """The slot capacity of ``exp``'s lag-tier fleet over ``members``
    (host precompute only)."""
    import dataclasses

    from repro_torch import api
    built = [dataclasses.replace(
        mem, env=mem.env.replace(**(mem.overrides or {})).build(),
        overrides=None) for mem in members]
    pdef = api.PROTOCOLS[type(exp.protocol)]
    return pdef.fleet_precompute(built, exp.protocol,
                                 rounds=exp.rounds).to_tier().capacity


def _drive_sweep(torch, task, label, exp, members, kernels, fails):
    """One ``run_sweep`` of ``exp`` (which evaluates every round) with
    every launch counter at 0 before it, its local training and its round
    functions timed per call, the peak device memory reset before it, and
    every member's global model kept at each eval.  Fails unless each
    kernel in ``kernels`` launched its count per round (per member-round
    on the sequential engine) and no other kernel launched.  Returns
    (histories, globals[t][s] after round t + 1, launch counts)."""
    from repro_torch.core import protocol
    from repro_torch.kernels import backend

    ex = exp.exec
    fleet = ex.engine == 'fleet'
    attr = ('local_train' + ('_rows' if ex.schedule != 'dense' else '')
            + ('_fleet' if fleet else ''))
    rounds, size = exp.rounds, len(members)
    caps = _capacities(exp, members) if ex.schedule != 'dense' else None
    if ex.schedule == 'sparse_tier':
        caps = f'{caps}, tier capacity {_tier_capacity(exp, members)}'
    originals = {f: getattr(protocol, f) for f in ROUND_FNS}
    train_s, round_s, seen = [], [], []
    evaluate = task.evaluate

    def keep(g):
        seen.append({k: v.clone() for k, v in g.items()})
        return evaluate(g)
    setattr(task, attr, _timed(torch, getattr(task, attr), train_s))
    task.evaluate = keep
    for f in ROUND_FNS:
        setattr(protocol, f, _timed(torch, originals[f], round_s))
    try:
        backend.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        hists = exp.compile().run_sweep(members)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        counts = {c: v for c, v in backend.LAUNCHES.items() if v}
    finally:
        for f in ROUND_FNS:
            setattr(protocol, f, originals[f])
        delattr(task, attr)
        del task.evaluate
    server_s = [r - t for r, t in zip(round_s, train_s)]
    per = 'fleet round' if fleet else 'member-round'
    print(f'{label}: K {caps} of m {members[0].env.m}; {wall:.2f} s for '
          f'{rounds} rounds of {size} members; per {per} train '
          f'{[round(v, 4) for v in train_s]} s, server step '
          f'{[round(v, 4) for v in server_s]} s; launches {counts}; peak '
          f'device memory {peak / 2**30:.3f} GiB')
    print(f'{label}: members\' final_global sha256 '
          f'{[_fingerprint(h.final_global) for h in hists]}')
    want = {c: n * rounds * (1 if fleet else size)
            for c, n in kernels.items()}
    if counts != want:
        fails.append(f'{label}: launches {counts}, want {want}')
    if fleet:
        kept = [seen[t * size:(t + 1) * size] for t in range(rounds)]
    else:
        kept = [[seen[i * rounds + t] for i in range(size)]
                for t in range(rounds)]
    return hists, kept, counts


def _sparse_sweeps(torch, spec, task, fails: list) -> dict:
    from repro_torch import api

    rounds = SPARSE_ROUNDS
    safa = api.SafaSpec()
    q8 = {'quantize_packed': 1, 'safa_aggregate_packed_q8': 1}
    wire = {'quantize_packed': 1, 'dequantize_packed': 1}
    # (label, spec, exec fields, a single run's launches per round): the
    # sparse cells run on both engines, their dense references as fleets
    sparse = [
        ('safa-delta-packed', safa,
         dict(schedule='sparse_delta', use_kernel='packed'), DELTA_PACKED),
        ('safa-delta-packed-int8', safa,
         dict(schedule='sparse_delta', use_kernel='packed', wire='int8'),
         DELTA_PACKED_Q8),
        ('safa-sparse-packed', safa,
         dict(schedule='sparse', use_kernel='packed'),
         {'safa_aggregate_packed': 1}),
        ('fedavg-delta-int8', api.FedAvgSpec(),
         dict(schedule='sparse_delta', wire='int8'), wire),
        ('fedcs-sparse', api.FedCSSpec(), dict(schedule='sparse'), {}),
    ]
    dense = [
        ('safa-dense-packed', safa, dict(use_kernel='packed'),
         {'safa_aggregate_packed': 1}),
        ('safa-dense-int8', safa, dict(wire='int8'), q8),
        ('fedavg-dense-int8', api.FedAvgSpec(), dict(wire='int8'), wire),
        ('fedcs-dense', api.FedCSSpec(), {}, {}),
    ]
    # f32: (fleet run, its reference, tolerance after all rounds); every
    # pair is held within 1e-5 after one round.  'sequential' is the same
    # cell on the sequential engine.
    paper_f32 = [('safa-delta-packed', 'sequential', 1e-5),
                 ('safa-delta-packed', 'safa-dense-packed', 1e-5),
                 ('safa-sparse-packed', 'sequential', 1e-5),
                 ('safa-sparse-packed', 'safa-dense-packed', 1e-5),
                 ('fedcs-sparse', 'sequential', STATELESS_TOL),
                 ('fedcs-sparse', 'fedcs-dense', STATELESS_TOL)]
    paper_q8 = [('safa-delta-packed-int8', 'sequential'),
                ('safa-delta-packed-int8', 'safa-dense-int8'),
                ('fedavg-delta-int8', 'sequential'),
                ('fedavg-delta-int8', 'fedavg-dense-int8')]
    launches = {}

    def sweep(env_task, members, init, runs, engines):
        kept = {}
        for label, sp, ex, kernels in runs:
            for engine in engines:
                tag = f'sparse sweep[{label}, {engine}]'
                exp = api.Experiment(env_task, None, sp, api.ExecSpec(
                    engine=engine, eval_every=1, **ex), rounds=rounds)
                hists, kept[label, engine], counts = _drive_sweep(
                    torch, env_task, tag, exp, members,
                    _fleet_forms(kernels) if engine == 'fleet' else kernels,
                    fails)
                for i, h in enumerate(hists):
                    _check_losses(f'{tag} member {i}',
                                  [e['loss'] for _, e in h.evals()],
                                  init[i], fails)
                if engine == 'fleet' and label in ('safa-delta-packed',
                                                   'safa-delta-packed-int8'):
                    for c in _fleet_forms(kernels):
                        if c != 'quantize_packed_fleet':
                            launches[c] = counts.get(c, 0)
        return kept

    def diff(a, b, t):
        return max(_max_diff(x, y) for x, y in zip(a[t], b[t]))

    def compare(kept, f32_pairs, q8_pairs):
        def ref_of(run, ref):
            return kept[run, 'sequential'] if ref == 'sequential' \
                else kept[ref, 'fleet']
        for run, ref, tol in f32_pairs:
            a, b = kept[run, 'fleet'], ref_of(run, ref)
            one, last = diff(a, b, 0), diff(a, b, rounds - 1)
            print(f'sparse sweep: {run} fleet vs {ref} final_global max abs '
                  f'diff over members after 1 round {one:.3e} (tolerance '
                  f'1e-05), after {rounds} rounds {last:.3e} (tolerance '
                  f'{tol:.0e})')
            if not (one <= 1e-5 and last <= tol):
                fails.append(f'sparse sweep: {run} fleet vs {ref} differ by '
                             f'{one:.3e} after 1 round, {last:.3e} after '
                             f'{rounds}')
        # int8 as the sparse phase holds it: 1e-4 after one round, one
        # quantisation step of the largest weight after the last
        for run, ref in q8_pairs:
            a, b = kept[run, 'fleet'], ref_of(run, ref)
            one, last = diff(a, b, 0), diff(a, b, rounds - 1)
            bound = max(v.abs().max().item() for g in b[-1]
                        for v in g.values()) / 127
            print(f'sparse sweep: {run} fleet vs {ref} final_global max abs '
                  f'diff over members after 1 round {one:.3e} (tolerance '
                  f'1e-04), after {rounds} rounds {last:.3e} (bound '
                  f'{bound:.3e} = max |w| / 127)')
            if not (one <= 1e-4 and last <= bound):
                fails.append(f'sparse sweep: {run} fleet vs {ref} differ by '
                             f'{one:.3e} after 1 round, {last:.3e} after '
                             f'{rounds}')

    # (a) the paper's environment, the fleet phase's four members
    members = [api.SweepMember(env=spec, fraction=0.3, lag_tolerance=5,
                               seed=i, overrides={'crash_prob': cr})
               for i, cr in enumerate(FLEET_CRASH)]
    init = [task.evaluate(task.init_global(i))['loss'] for i in range(S)]
    print(f'sparse sweep: m = {spec.m}, {S} members, crash rates '
          f'{FLEET_CRASH}, initial eval losses {init}; rounds {rounds}')
    kept = sweep(task, members, init, sparse, ('fleet', 'sequential'))
    kept.update(sweep(task, members, init, dense, ('fleet',)))
    compare(kept, paper_f32, paper_q8)
    del kept
    torch.cuda.empty_cache()

    # (b) the quota-bounded environment at m = 1000: four scale_spec()
    # members, SAFA sparse_delta packed; a dense fleet would not fit
    scale_env, scale_task = cnn_setup(torch, scale_spec())
    scale = api.SafaSpec(fraction=QUOTA / SCALE_M, lag_tolerance=10 * rounds)
    members = [api.SweepMember(env=scale_spec(i), fraction=QUOTA / SCALE_M,
                               lag_tolerance=10 * rounds, seed=i)
               for i in range(S)]
    init = [scale_task.evaluate(scale_task.init_global(i))['loss']
            for i in range(S)]
    print(f'sparse sweep: m = {scale_env.m}, {S} members (env seeds 0-{S - 1}'
          f'), initial eval losses {init}; rounds {rounds}')
    kept = sweep(scale_task, members, init,
                 [('scale-delta-packed', scale,
                   dict(schedule='sparse_delta', use_kernel='packed'),
                   DELTA_PACKED),
                  ('scale-delta-packed-int8', scale,
                   dict(schedule='sparse_delta', use_kernel='packed',
                        wire='int8'), DELTA_PACKED_Q8)],
                 ('fleet', 'sequential'))
    compare(kept, [('scale-delta-packed', 'sequential', 1e-5)],
            [('scale-delta-packed-int8', 'sequential')])
    del kept, scale_task
    torch.cuda.empty_cache()
    return launches


#: the packed lag-tier round's launches, f32 and int8
TIER_PACKED = {'gather_rows': 1, 'safa_aggregate_packed_tier_rows': 1}
TIER_PACKED_Q8 = {'gather_rows': 1, 'quantize_packed': 1,
                  'safa_aggregate_packed_q8_tier_rows': 1}
TIER_M = 10_000         # the lag tier's large single run


def tier_phase(torch, fails: list) -> dict:
    """The lag tier (``schedule='sparse_tier'``) on Task 2's CNN at full
    width, on the quota-bounded environment: single runs at m = 1000
    against ``'sparse_delta'`` packed on the same events, a run at
    m = 10,000, and a 4-member sweep at m = 1000 on both engines; returns
    the launch counts of kernels 19 and 20 and their S-axis forms in the
    runs that drive them.  Trains with deterministic cuDNN, as the sparse
    phases do."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _tier_runs(torch, fails)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _tier_runs(torch, fails: list) -> dict:
    from repro_torch import api
    from repro_torch.kernels import backend

    rounds = SPARSE_ROUNDS
    safa = api.SafaSpec(fraction=QUOTA / SCALE_M, lag_tolerance=10 * rounds)
    tier = dict(schedule='sparse_tier', use_kernel='packed')
    delta = dict(schedule='sparse_delta', use_kernel='packed')
    # (label, exec fields, launches per round)
    runs = [('tier-packed', tier, TIER_PACKED),
            ('tier-packed-int8', dict(tier, wire='int8'), TIER_PACKED_Q8),
            ('tier-plain', dict(schedule='sparse_tier'), {}),
            ('delta-packed', delta, DELTA_PACKED),
            ('delta-packed-int8', dict(delta, wire='int8'), DELTA_PACKED_Q8)]
    launches, peaks = {}, {}
    spec, task = cnn_setup(torch, scale_spec())
    init = task.evaluate(task.init_global(0))['loss']
    print(f'tier: m = {spec.m}, initial eval loss {init:.6f}; rounds '
          f'{rounds}')

    def run_all(env_spec, env_task, cells, n_rounds, init):
        finals = {}
        for label, ex, kernels in cells:
            tag = f'tier[{label}, {n_rounds} round{"s" * (n_rounds > 1)}]'
            exp = api.Experiment(env_task, env_spec, safa,
                                 api.ExecSpec(eval_every=n_rounds, **ex),
                                 rounds=n_rounds)
            hist = _drive_run(torch, env_task, tag, exp, kernels, fails)
            _check_losses(tag, [e['loss'] for _, e in hist.evals()], init,
                          fails)
            finals[label] = hist.final_global
            if n_rounds == rounds:
                peaks[label] = (exp.env.m, hist.peak,
                                getattr(exp.precompute(), 'capacity', None)
                                if ex['schedule'] == 'sparse_tier' else None)
                if label in ('tier-packed', 'tier-packed-int8'):
                    for c in kernels:
                        if 'tier' in c:
                            launches[c] = backend.LAUNCHES[c]
        return finals

    finals = run_all(spec, task, runs, rounds, init)
    first = run_all(spec, task, runs, 1, init)
    # f32: the tier and sparse_delta run the same slot math over other
    # storage (another summation order): within 1e-5 after one round and
    # after two; the packed and plain tier the same
    for run, ref in (('tier-packed', 'delta-packed'),
                     ('tier-plain', 'delta-packed'),
                     ('tier-packed', 'tier-plain')):
        one = _max_diff(first[run], first[ref])
        diff = _max_diff(finals[run], finals[ref])
        print(f'tier: {run} vs {ref} final_global max abs diff after 1 '
              f'round {one:.3e} (tolerance 1e-05), after {rounds} rounds '
              f'{diff:.3e} (tolerance 1e-05)')
        if not (one <= 1e-5 and diff <= 1e-5):
            fails.append(f'tier: {run} vs {ref} differ by {one:.3e} after 1 '
                         f'round, {diff:.3e} after {rounds}')
    # int8 as the sparse phase holds it: 1e-4 after one round, one
    # quantisation step of the largest weight after the last
    run, ref = 'tier-packed-int8', 'delta-packed-int8'
    one = _max_diff(first[run], first[ref])
    diff = _max_diff(finals[run], finals[ref])
    bound = max(v.abs().max().item() for v in finals[ref].values()) / 127
    print(f'tier: {run} vs {ref} final_global max abs diff after 1 round '
          f'{one:.3e} (tolerance 1e-04), after {rounds} rounds {diff:.3e} '
          f'(bound {bound:.3e} = max |w| / 127)')
    if not (one <= 1e-4 and diff <= bound):
        fails.append(f'tier: {run} vs {ref} differ by {one:.3e} after 1 '
                     f'round, {diff:.3e} after {rounds}')
    del finals, first

    # a 4-member sweep at m = 1000 (env seeds 0-3), both engines: fleet
    # and sequential replay one program, so every member's global is the
    # same bits after every round
    members = [api.SweepMember(env=scale_spec(i), fraction=QUOTA / SCALE_M,
                               lag_tolerance=10 * rounds, seed=i)
               for i in range(S)]
    inits = [task.evaluate(task.init_global(i))['loss'] for i in range(S)]
    print(f'tier sweep: m = {spec.m}, {S} members (env seeds 0-{S - 1}), '
          f'initial eval losses {inits}; rounds {rounds}')
    for label, ex, kernels in runs[:2]:
        kept = {}
        for engine in ('fleet', 'sequential'):
            tag = f'tier sweep[{label}, {engine}]'
            exp = api.Experiment(task, None, safa, api.ExecSpec(
                engine=engine, eval_every=1, **ex), rounds=rounds)
            hists, kept[engine], counts = _drive_sweep(
                torch, task, tag, exp, members,
                _fleet_forms(kernels) if engine == 'fleet' else kernels,
                fails)
            for i, h in enumerate(hists):
                _check_losses(f'{tag} member {i}',
                              [e['loss'] for _, e in h.evals()], inits[i],
                              fails)
            if engine == 'fleet':
                for c in _fleet_forms(kernels):
                    if 'tier' in c:
                        launches[c] = counts.get(c, 0)
        per_round = [max(_max_diff(a, b) for a, b in zip(fa, sa))
                     for fa, sa in zip(kept['fleet'], kept['sequential'])]
        print(f'tier sweep: {label} fleet - sequential final_global max abs '
              f'diff over members after each round {per_round} (want 0: '
              f'the same bits)')
        if any(d != 0 for d in per_round):
            fails.append(f'tier sweep: {label} fleet and sequential differ '
                         f'({per_round})')
        del kept
    del task
    torch.cuda.empty_cache()

    # m = 10,000: the buffer stays capacity + 1 rows
    big_spec, big_task = cnn_setup(torch, scale_spec(m=TIER_M))
    big = api.SafaSpec(fraction=QUOTA / TIER_M, lag_tolerance=10 * rounds)
    exp = api.Experiment(big_task, big_spec, big,
                         api.ExecSpec(eval_every=rounds, **tier),
                         rounds=rounds)
    big_init = big_task.evaluate(big_task.init_global(0))['loss']
    print(f'tier: m = {TIER_M}, initial eval loss {big_init:.6f}; rounds '
          f'{rounds}')
    hist = _drive_run(torch, big_task, f'tier[tier-packed-m{TIER_M}, '
                      f'{rounds} rounds]', exp, TIER_PACKED, fails)
    _check_losses(f'tier[tier-packed-m{TIER_M}]',
                  [e['loss'] for _, e in hist.evals()], big_init, fails)
    peaks[f'tier-packed-m{TIER_M}'] = (TIER_M, hist.peak,
                                       exp.precompute().capacity)
    for label in ('delta-packed', 'tier-packed', f'tier-packed-m{TIER_M}'):
        m, peak, cap = peaks[label]
        print(f'tier: {label}: m {m}, tier capacity {cap}, peak device '
              f'memory {peak / 2**30:.3f} GiB')
    del big_task, hist
    torch.cuda.empty_cache()
    return launches


def weighted_phase(torch, spec, task, fails: list) -> dict:
    """The staleness-adaptive family on Task 2's CNN at full width through
    the port's entry points: SEAFL packed, int8 + packed and plain, CSAFL
    packed, a 4-member mixed-scheme sweep packed and plain, and the folded
    FedAsync member against the sequential FedAsync engine; returns the
    launch counts of kernel 10's two forms in the runs that drive them."""
    # the comparisons below would otherwise measure cuDNN's run-to-run
    # noise (its default weight-gradient algorithms add with atomics)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _weighted_runs(torch, spec, task, fails)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _weighted_runs(torch, spec, task, fails: list) -> dict:
    from repro_torch import api
    from repro_torch.core import agg_schemes, protocol

    rounds = WEIGHTED_ROUNDS
    init_loss = [task.evaluate(task.init_global(s))['loss']
                 for s in range(S)]
    print(f'weighted: {_card_line()}; initial eval losses {init_loss}; '
          f'rounds {rounds}')
    steps = ('weighted_server_step', 'fedasync_merge')
    merge = ('weighted_merge_packed',)
    runs = [('seafl-packed', api.SeaflSpec(), dict(use_kernel='packed'),
             merge),
            ('seafl-int8', api.SeaflSpec(),
             dict(use_kernel='packed', wire='int8'),
             merge + ('quantize_packed', 'dequantize_packed')),
            ('seafl-plain', api.SeaflSpec(), {}, ()),
            ('csafl-packed', api.CsaflSpec(clusters=2),
             dict(use_kernel='packed'), merge)]
    launches, finals = {}, {}
    for name, sp, ex, kernels in runs:
        exp = api.Experiment(task, spec, sp,
                             api.ExecSpec(eval_every=rounds, **ex),
                             rounds=rounds)
        hist, counts = _drive(torch, task, f'weighted[{name}]', steps,
                              kernels, rounds, exp.compile().run, False,
                              fails)
        launches.setdefault('weighted_merge_packed',
                            counts['weighted_merge_packed'])
        _check_losses(f'weighted[{name}]', [e['loss'] for _, e in
                                            hist.evals()],
                      init_loss[0], fails)
        finals[name] = hist.final_global
    diff = _max_diff(finals['seafl-packed'], finals['seafl-plain'])
    print(f'weighted: SEAFL packed vs plain final_global max abs diff '
          f'{diff:.3e}')
    if not diff <= 1e-5:
        fails.append(f'weighted: SEAFL packed vs plain differ by {diff:.3e}')

    members = [api.SweepMember(env=spec, seed=s,
                               overrides=dict(ov, crash_prob=cr))
               for s, (ov, cr) in enumerate(MIXED)]
    sweeps = {}
    for name, ex, kernels in (
            ('packed', dict(use_kernel='packed'),
             ('weighted_merge_packed_fleet',)),
            ('plain', {}, ())):
        exp = api.Experiment(task, None, api.SeaflSpec(),
                             api.ExecSpec(eval_every=rounds, **ex),
                             rounds=rounds)
        hists, counts = _drive(torch, task, f'weighted sweep[{name}]', steps,
                               kernels, rounds,
                               lambda: exp.compile().run_sweep(members),
                               True, fails)
        if kernels:
            launches[kernels[0]] = counts[kernels[0]]
        for s, h in enumerate(hists):
            _check_losses(f'weighted sweep[{name}] member {s}',
                          [e['loss'] for _, e in h.evals()], init_loss[s],
                          fails)
        sweeps[name] = [h.final_global for h in hists]
    diffs = [_max_diff(p, q) for p, q in zip(sweeps['packed'],
                                             sweeps['plain'])]
    print(f'weighted: sweep packed vs plain final_global max abs diff per '
          f'member {diffs}')
    if not max(diffs) <= 1e-5:
        fails.append(f'weighted: sweep packed vs plain differ by {diffs}')

    # the fold at one server step, where the JAX package's tolerance holds
    # elementwise: the folded FedAsync member's first-round row (kernel 10)
    # and the sequential chain's merges of the same uploads
    folded = members[-1]
    env = spec.replace(crash_prob=MIXED[-1][1])
    dev = torch.device('cuda')
    fold = agg_schemes.precompute_weighted_schedule(
        env.build(), rounds=1, scheme='fedasync').to_device(dev)
    chain = agg_schemes.precompute_async_schedule(env.build(),
                                                  rounds=1).to_device(dev)
    g = task.init_global(folded.seed)
    gen = torch.Generator(device=dev).manual_seed(3)
    uploads = {k: v + 0.01 * torch.randn((spec.m,) + tuple(v.shape),
                                         generator=gen, device=dev)
               for k, v in g.items()}
    got = protocol.weighted_merge(g, uploads, wrow=fold.wrow[0],
                                  use_kernel='packed')
    want = protocol.fedasync_merge(g, uploads, order=chain.order[0],
                                   alphas=chain.alphas[0])
    bad = [k for k in want if not torch.allclose(got[k], want[k], rtol=2e-5,
                                                 atol=1e-7)]
    print(f'weighted: one folded server step vs the sequential chain: max '
          f'abs diff {_max_diff(got, want):.3e}')
    if bad:
        fails.append(f'weighted: the folded merge beyond rtol 2e-5 of the '
                     f'sequential chain in {bad}')

    # and over a run, against the sequential FedAsync engine on the
    # member's env and init: both through the single-run training (the
    # fleet trains its replicas in batches of another size), so that they
    # differ by the fold's rounding as training carries it on
    seq = api.Experiment(task, env, api.FedAsyncSpec(alpha=folded.alpha,
                                                     staleness_exp=folded
                                                     .staleness_exp),
                         api.ExecSpec(eval_every=rounds), rounds=rounds,
                         seed=folded.seed)
    ref, _ = _drive(torch, task, 'weighted[fedasync sequential]', steps, (),
                    rounds, seq.compile().run, False, fails)
    exp = api.Experiment(task, None, api.SeaflSpec(),
                         api.ExecSpec(engine='sequential', eval_every=rounds,
                                      use_kernel='packed'), rounds=rounds)
    (hist,), _ = _drive(torch, task, 'weighted[fedasync folded]', steps,
                        merge, rounds,
                        lambda: exp.compile().run_sweep([folded]), False,
                        fails)
    diff = _max_diff(hist.final_global, ref.final_global)
    scale = max(v.abs().max().item() for v in ref.final_global.values())
    losses = [[e['loss'] for _, e in h.evals()] for h in (hist, ref)]
    fleet_diff = _max_diff(sweeps['packed'][-1], ref.final_global)
    print(f'weighted: folded vs sequential FedAsync final_global max abs '
          f'diff {diff:.3e}, bound 2e-5 x max |w| = {2e-5 * scale:.3e} (the '
          f'fleet member: {fleet_diff:.3e}); eval losses {losses[0]} vs '
          f'{losses[1]}')
    if not (diff <= 2e-5 * scale
            and math.isclose(losses[0][-1], losses[1][-1], rel_tol=2e-5)):
        fails.append(f'weighted: folded FedAsync beyond rtol 2e-5 of the '
                     f'sequential engine ({diff:.3e}; losses {losses})')
    return launches


def band_pairs(S: int, window) -> int:
    """(query, key) pairs of one head's causal band: sum over i < S of
    min(i + 1, window)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attention_kernel_phase(torch, fails: list) -> list:
    """Kernel 21 (``swa_attention``) against its plain version on the card:
    at the bulk prefill's shape (h2o-danube-3-4b: B = 1, S = 8192, 32
    heads over 8 KV heads, head_dim 120, window 4096) and at odd shapes,
    f32 and bf16; f32 within 2e-5 and bf16 within 3e-2 of the plain
    version computed in f32 from the same inputs (the JAX package's
    tolerances, ``tests/test_kernels.py``), bf16 also elementwise within
    ``BF16_RTOL`` of the plain output and its spread, plus ``BF16_ATOL``
    (printed as the worst ratio of error to that bound); and in bf16 at
    the families' prefill shapes (``FAMILY_ATTN``: llama4-scout's,
    zamba2-1.2b's shared block's, internvl2-26b's and whisper-medium's
    decoder's heads, no window).  Timed in
    bf16 at the prefill shape and the families' shapes beside the plain
    version and ``scaled_dot_product_attention`` (a boolean band mask
    where there is a window, else ``is_causal``; ``enable_gqa=True``;
    timed only), and the f32 entry at the prefill shape beside SDPA in
    f32.  Returns the records: the prefill shape's (``swa_attention``),
    then one for each family shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.swa_attention import swa_attention

    cfg = get_config(ARCH)
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev)
    main = (PREFILL_B, PREFILL_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.window)
    f32 = ((torch.float32, 2e-5),)
    bf16 = ((torch.bfloat16, BF16_OUTER),)
    errs, ratios = {}, {}
    for (B, S, H, KH, D, win), dtypes in (
            [(shape, f32 + bf16) for shape in (main,) + ATTN_ODD]
            + [(shape, bf16) for shape in FAMILY_ATTN.values()]):
        gen.manual_seed(S + (win or 0))
        qkv = [torch.randn((B, S, h, D), generator=gen, device=dev)
               for h in (H, KH, KH)]
        for dtype, tol in dtypes:
            q, k, v = (t.to(dtype) for t in qkv)
            out = swa_attention(q, k, v, window=win)
            want = ref.swa_attention_ref(q.float(), k.float(), v.float(),
                                         window=win)
            torch.cuda.synchronize()
            key = (B, S, H, KH, D, win, str(dtype))
            diff = (out.float() - want).abs()
            err = errs[key] = diff.max().item()
            ratio = 0.0
            if dtype == torch.bfloat16:
                bound = ref.swa_attention_spread_ref(q, k, v, window=win)
                bound.add_(want.abs()).mul_(BF16_RTOL).add_(BF16_ATOL)
                ratio = ratios[key] = (diff / bound).max().item()
                del bound
            if not (out.dtype == dtype and err <= tol and ratio <= 1):
                fails.append(f'swa_attention {(B, S, H, KH, D, win)} '
                             f'{dtype}: max abs err {err:.3e} (tolerance '
                             f'{tol}), worst error / bf16 bound {ratio:.3f} '
                             f'(bf16 only, at most 1), dtype {out.dtype}')
            del out, want, diff, q, k, v
        del qkv
        torch.cuda.empty_cache()
    for key, err in errs.items():
        scaled = (f'; worst error / ({BF16_RTOL} (|plain| + spread) + '
                  f'{BF16_ATOL}) {ratios[key]:.3f}' if key in ratios else '')
        print(f'attention: {key} max abs err vs plain {err:.3e}{scaled}')

    recs = [_attention_record(torch, 'swa_attention', main,
                              errs[main + (str(torch.bfloat16),)])]
    for arch, shape in FAMILY_ATTN.items():
        recs.append(_attention_record(
            torch, family_attn_record(arch), shape,
            errs[shape + (str(torch.bfloat16),)], plain_timed=1))
    # the f32 entry (the CUDA-core kernel), timed only: no path of the
    # smoke runs f32 at full width, so it has no record of its own
    _attention_record(torch, 'swa_attention f32 entry', main,
                      errs[main + (str(torch.float32),)], plain_timed=0,
                      dtype=torch.float32, peak_flops=PEAK_FLOPS)
    B, S, H, KH, D, win = main
    long_attention(torch, H, KH, D, win)
    return recs


def family_attn_record(arch: str) -> str:
    """The name of kernel 21's record at ``arch``'s prefill shape."""
    return 'swa_attention_' + arch.split('-')[0]


def _attention_inputs(torch, shape, dtype, seed=0):
    B, S, H, KH, D, _ = shape
    gen = torch.Generator(device='cuda').manual_seed(seed)
    return [torch.randn((B, S, h, D), generator=gen, device='cuda').to(dtype)
            for h in (H, KH, KH)]


def _attention_record(torch, name, shape, err, plain_timed=3,
                      dtype=None, peak_flops=PEAK_BF16_FLOPS):
    """Kernel 21 timed at ``shape`` in ``dtype`` (bf16 if None) beside its
    plain version (not timed where ``plain_timed`` is 0) and SDPA, against
    its bound: 4 D flops a band pair at ``peak_flops`` (the bf16
    tensor-core rate; the f32 entry runs on the CUDA cores)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.swa_attention import swa_attention

    dtype = dtype or torch.bfloat16
    B, S, H, KH, D, win = shape
    q, k, v = _attention_inputs(torch, shape, dtype)
    ms = _time_ms(torch, lambda: swa_attention(q, k, v, window=win), 2, 10)
    plain = (_time_ms(torch, lambda: ref.swa_attention_ref(q, k, v,
                                                           window=win),
                      1, plain_timed) if plain_timed else None)
    sdpa, backend_name = _sdpa_band(torch, q, k, v, win)
    lib = _time_ms(torch, sdpa, 2, 10)
    lib_err = (sdpa().transpose(1, 2).float() - ref.swa_attention_ref(
        q, k, v, window=win).float()).abs().max().item()
    pairs = band_pairs(S, win) * B * H
    flops = 4 * D * pairs
    nbytes = q.element_size() * (2 * B * S * H * D + 2 * B * S * KH * D)
    rec = _record(name, 'src/repro_torch/csrc/swa_attention.cu',
                  'src/repro/kernels/swa_attention.py:45', err, ms, plain,
                  nbytes, flops, nbytes, library_ms=lib,
                  peak_flops=peak_flops)
    print(f'kernel {name} (B {B}, S {S}, H {H}, KH {KH}, D {D}, '
          f'window {win}, {str(dtype).split(".")[-1]}): {ms} ms (plain '
          f'{plain} ms, scaled_dot_product_attention {lib} ms on the '
          f'{backend_name} backend, max abs diff to plain {lib_err:.3e}); '
          f'bound {rec["bound_ms"]} ms by {rec["bound_by"]} ({pairs} band '
          f'pairs, {flops / 1e9:.1f} GFLOP at {peak_flops / 1e12:.0f} '
          f'TFLOP/s; {nbytes / 1e6:.1f} MB at {PEAK_BYTES / 1e12} TB/s); '
          f'{flops / ms / 1e9:.1f} TFLOP/s achieved, '
          f'{rec["bound_ms"] / ms:.1%} of the bound')
    del q, k, v, sdpa
    torch.cuda.empty_cache()
    return rec


def _sdpa_band(torch, q, k, v, win):
    """``scaled_dot_product_attention`` on q [B, S, H, D], k, v [B, S, KH,
    D] with a boolean causal band mask (``is_causal`` where there is no
    window inside S) and ``enable_gqa=True``: the library call timed
    beside kernel 21 (never called by the port).  Returns the call and
    the name of the backend PyTorch picks for it."""
    import torch.nn.functional as F
    S = q.shape[1]
    kw = {'is_causal': True}
    if win is not None and win < S:
        pos = torch.arange(S, device=q.device)
        kw = {'attn_mask': (pos[:, None] >= pos[None, :])
              & (pos[:, None] - pos[None, :] < win)}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                              **kw)
    try:
        from torch.nn.attention import SDPBackend
        backend_name = SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, enable_gqa=True, **kw)).name
    except Exception as e:  # noqa: BLE001 - a private API: report only
        backend_name = f'not known ({e!r})'
    return sdpa, backend_name


def long_attention(torch, H, KH, D, win):
    """Kernel 21 timed only at ``INPUT_SHAPES['prefill_32k']``'s sequence
    length (B 1, bf16) beside ``scaled_dot_product_attention`` with its
    boolean band mask: the plain version's f32 [S, S] scores would take
    137 GB over the 32 heads there."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.kernels.swa_attention import swa_attention

    B, S = 1, INPUT_SHAPES['prefill_32k'].seq_len
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, KH, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, KH, D), generator=gen, device=dev).bfloat16()
    ms = _time_ms(torch, lambda: swa_attention(q, k, v, window=win), 2, 10)
    sdpa, _ = _sdpa_band(torch, q, k, v, win)
    lib = _time_ms(torch, sdpa, 1, 3)
    flops = 4 * D * band_pairs(S, win) * B * H
    bound = flops / PEAK_BF16_FLOPS * 1e3
    print(f'kernel swa_attention (B {B}, S {S}, H {H}, KH {KH}, D {D}, '
          f'window {win}, bf16), timed only: {ms} ms, '
          f'scaled_dot_product_attention {lib} ms; {flops / 1e9:.1f} GFLOP '
          f'of band pairs, bound {bound} ms by operations; '
          f'{flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} of the bound')
    del q, k, v, sdpa
    torch.cuda.empty_cache()


def serve_phase(torch, attn_ms: float, fails: list,
                readings: dict) -> dict:
    """h2o-danube-3-4b at full width and depth (24 layers, d_model 3840,
    32/8 heads, head_dim 120, bf16), random init on the card, through the
    port's serving entry points: ``ServeSetup.prefill_step`` (bulk
    prefill) with ``attn_impl='pallas'`` against ``'flash_jnp'``, the
    teacher-forced ``Model.prefill`` against ``forward_logits``, greedy
    decode through ``ServeSetup.serve_step``, then ``serve.run`` at the
    JAX CLI's defaults.  Returns the launches of kernel 21 in the prefill
    step.  Deterministic settings: TF32 off (PyTorch's default) and bf16
    products reduced in f32 (``allow_bf16_reduced_precision_reduction =
    False``), as the reference accumulates."""
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return _serve_runs(torch, attn_ms, fails, readings)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced


def _serve_runs(torch, attn_ms: float, fails: list,
                readings: dict) -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import backend
    from repro_torch.launch import serve, steps
    from repro_torch.models import model as model_mod

    dev = torch.device('cuda')
    cfg = get_config(ARCH)
    flash = model_mod.build_model(cfg)
    kern = model_mod.build_model(dataclasses.replace(cfg, attn_impl='pallas'))
    n = kern.n_params()
    print(f'serve: {ARCH} {cfg.n_layers} layers, d_model {cfg.d_model}, '
          f'{cfg.n_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, '
          f'd_ff {cfg.d_ff}, window {cfg.window}, {cfg.dtype}: {n:,} '
          f'parameters')
    if n != 3_961_839_360:
        fails.append(f'serve: {n} parameters, want 3,961,839,360')
    torch.cuda.synchronize()
    t = time.perf_counter()
    params = _measured_init(torch, readings, ARCH, lambda: kern.init(
        torch.Generator(device=dev).manual_seed(0)))
    print(f'serve: init on the card {time.perf_counter() - t:.2f} s, '
          f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated')

    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                           generator=torch.Generator().manual_seed(1))
    batch = {'tokens': tokens.to(dev)}
    setup = steps.ServeSetup(kern)
    backend.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    nxt = setup.prefill_step(params, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t
    counts = dict(backend.LAUNCHES)
    launches = {'swa_attention': counts['swa_attention']}
    others = {k: c for k, c in counts.items() if c and k != 'swa_attention'}
    if counts['swa_attention'] != cfg.n_layers or others:
        fails.append(f'serve: prefill_step launched swa_attention '
                     f'{counts["swa_attention"]} times (want '
                     f'{cfg.n_layers}), others {others}')
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        setup.prefill_step(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    profile_train(torch, 'serve profile (one prefill_step, pallas)',
                  lambda: setup.prefill_step(params, batch))
    torch.cuda.synchronize()
    t = time.perf_counter()
    nxt_flash = steps.ServeSetup(flash).prefill_step(params, batch)
    torch.cuda.synchronize()
    flash_s = time.perf_counter() - t
    share = cfg.n_layers * attn_ms / 1e3 / min(secs)
    readings['prefill_s'] = secs
    print(f'serve: prefill_step [{PREFILL_B}, {PREFILL_S}] pallas '
          f'(kernel 21): first {first:.4f} s, then {[round(s, 4) for s in secs]} '
          f's ({PREFILL_B * PREFILL_S / min(secs):.0f} tokens/s); kernel 21 '
          f'{cfg.n_layers} x {attn_ms:.3f} ms = {share:.1%} of it; '
          f'flash_jnp {flash_s:.4f} s; next tokens {nxt.tolist()} / '
          f'{nxt_flash.tolist()}')
    if not torch.equal(nxt, nxt_flash):
        fails.append(f'serve: prefill_step next tokens {nxt.tolist()} '
                     f'(pallas) != {nxt_flash.tolist()} (flash_jnp)')

    lk = kern.logits(params, batch)[0].float()
    lf = flash.logits(params, batch)[0].float()
    gap = (lk - lf).abs().max().item()
    last = lk[:, -1, :cfg.vocab_size].topk(2).values
    print(f'serve: logits pallas vs flash_jnp max abs gap {gap:.4e} over '
          f'{lk.numel():,} (bound {PREFILL_GAP}; largest |logit| '
          f'{lf.abs().max().item():.3f}; last row top-2 margin '
          f'{(last[:, 0] - last[:, 1]).tolist()})')
    if not (torch.isfinite(lk).all() and gap <= PREFILL_GAP):
        fails.append(f'serve: pallas vs flash_jnp logits gap {gap:.4e} '
                     f'(bound {PREFILL_GAP}) or not finite')
    del lk, lf

    prompt = batch['tokens'][:, :TEACHER_LEN]
    cache = kern.init_cache(PREFILL_B, TEACHER_LEN, device=dev)
    _, step = kern.prefill(params, cache, prompt)
    for label, model in (('flash_jnp', flash), ('pallas', kern)):
        full = model.logits(params, {'tokens': prompt})[0].float()
        diff = (step.float() - full).abs().max().item()
        print(f'serve: teacher-forced Model.prefill vs forward_logits '
              f'({label}) on {TEACHER_LEN} tokens: max abs diff {diff:.4e} '
              f'(tolerance {TEACHER_TOL})')
        if not diff <= TEACHER_TOL:
            fails.append(f'serve: teacher-forced prefill vs forward_logits '
                         f'({label}) {diff:.4e} > {TEACHER_TOL}')
    del cache, step, full

    # greedy decode through ServeSetup.serve_step on serve.run's params
    # (the same seed and draws) and prompts, to hold serve.run to
    B, P, G = SERVE['batch'], SERVE['prompt_len'], SERVE['gen']
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(0))
    cache = kern.init_cache(B, P + G, device=dev)
    cache, logits = kern.prefill(params, cache, prompts.to(dev))
    tok = logits[:, -1].argmax(-1)
    greedy = [tok]
    for _ in range(G - 1):
        cache, tok = setup.serve_step(params, cache, tok[:, None])
        greedy.append(tok)
    greedy = torch.stack(greedy, dim=1)
    profile_train(torch, 'serve profile (one serve_step, B 4)',
                  lambda: setup.serve_step(params, cache, tok[:, None]))
    del params, cache, logits, batch
    torch.cuda.empty_cache()

    pre_s, dec_s = [], []
    orig = model_mod.Model.prefill, model_mod.Model.decode_step
    model_mod.Model.prefill = _timed(torch, orig[0], pre_s)
    model_mod.Model.decode_step = _timed(torch, orig[1], dec_s)
    torch.cuda.reset_peak_memory_stats()
    try:
        t = time.perf_counter()
        toks = serve.run(ARCH, full_size=True, **SERVE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        model_mod.Model.prefill, model_mod.Model.decode_step = orig
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f'serve: serve.run({ARCH!r}, full_size=True, {SERVE}): {wall:.2f} '
          f's wall; prefill {B}x{P} tokens {sum(pre_s):.4f} s '
          f'({B * P / sum(pre_s):.1f} tokens/s); decode {B}x{G - 1} tokens '
          f'{sum(dec_s):.4f} s ({B * (G - 1) / sum(dec_s):.1f} tokens/s, '
          f'{sum(dec_s) / len(dec_s) * 1e3:.2f} ms a step); peak device '
          f'memory {peak:.3f} GiB; ids {toks[0].tolist()}')
    if not (tuple(toks.shape) == (B, G) and torch.equal(toks, greedy)
            and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size):
        fails.append(f'serve: serve.run tokens {toks.tolist()} are not the '
                     f'serve_step greedy decode {greedy.tolist()}')
    return launches


#: phase 12's models: (arch, depth on the card, None for the published
#: depth, parameters at that depth: the reference's ``n_params``).  Only
#: the MoE models' depth is cut, never a width, an expert or the
#: vocabulary: at their published depth their params do not fit one card
#: (the dry run, phase 14, prints their bytes and ``fits_one_card``);
#: maverick keeps one whole super-block (a dense layer and a 128-expert
#: MoE layer).  internvl2-26b fits whole
FAMILIES = (('llama4-scout-17b-a16e', 8, 19_687_756_800),
            ('llama4-maverick-400b-a17b', 2, 18_555_233_280),
            ('mamba2-130m', None, 167_832_000),
            ('zamba2-1.2b', None, 1_170_473_856),
            ('internvl2-26b', None, 19_900_471_296),
            ('whisper-medium', None, 812_734_464))
#: the models whose ``serve.run`` the phase drives at full size: those at
#: their published depth but internvl2-26b, whose run would draw its 37.1
#: GiB again for the text-only decode the phase runs through ``serve_step``
SERVE_RUNS = ('mamba2-130m', 'zamba2-1.2b', 'whisper-medium')
#: an MoE model's pallas against flash_jnp logit comparison runs at the
#: no-drop capacity (``capacity_factor = n_experts``) on the first NODROP_S
#: tokens of the bulk prefill's S 8192: at that capacity an expert's queue
#: holds a whole group, so llama4-maverick's dispatch holds 128 x S slots,
#: and at S 8192 its [128, 8192, 8192] bf16 SwiGLU products (17.2 GB each)
#: do not fit beside its 34.6 GiB of weights
NODROP_S = 2048
#: bounds on the positions left out of an MoE model's logit comparison:
#: those whose top-1 route differs in some MoE layer between two bf16
#: paths.  A route is the argmax of 16 (128) router logits, and the two
#: paths' bf16 rounding in another order moves a near-tie to the other
#: expert.  With no drops a flip changes no other token's route or slot.
#: Of the NODROP_S positions (pallas against flash_jnp: 139 for
#: llama4-scout's 8 MoE layers, 8 for maverick's one) an eighth; of the
#: teacher-forced 64 (decode steps against forward_logits: 0-5) an eighth;
#: all measured on an H100 before these bounds were set
ROUTE_FLIPS, TEACHER_FLIPS = NODROP_S // 8, 8


def families_phase(torch, attn_ms: dict, fails: list,
                   readings: dict) -> dict:
    """The MoE (llama4-scout at 8 of 48 layers, llama4-maverick at one
    super-block), SSM (mamba2-130m), hybrid (zamba2-1.2b), VLM
    (internvl2-26b) and audio (whisper-medium) families at full width,
    one after the other, random init on the card, through the port's
    serving entry points, as the serve phase drives h2o-danube-3-4b:
    ``prefill_step`` on B 1 x S 8192 (with the VLM's seeded patch or the
    audio family's frame embeddings) on both ``attn_impl``s where the
    model has attention (kernel 21 once per causal attention
    application; published capacity 1.25, its ``dropped_frac``
    and ``load_balance_loss`` printed); at ``capacity_factor = n_experts``
    (no drops, as a decode step has none) the two ``attn_impl``s' logits
    (an MoE model's on the first ``NODROP_S`` tokens) within
    ``PREFILL_GAP`` at the positions whose routes agree in every MoE
    layer, the count of the others within ``ROUTE_FLIPS``, and the
    teacher-forced ``Model.prefill`` on 64 tokens within ``TEACHER_TOL``
    of ``forward_logits`` (whisper's cross caches filled from the
    encoder; none for the VLM, whose decode has no patch context);
    greedy decode through ``serve_step`` at B 4; ``serve.run`` at the JAX
    CLI's defaults with ``full_size=True`` for ``SERVE_RUNS``, which must
    give that decode's tokens.  Returns kernel 21's launches in the
    prefill of each model of ``FAMILY_ATTN`` under its record's name."""
    matmul = torch.backends.cuda.matmul
    reduced = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    launches = {}
    try:
        for arch, depth, n_want in FAMILIES:
            launches.update(_family_run(torch, arch, depth, n_want, attn_ms,
                                        fails, readings))
            torch.cuda.empty_cache()
    finally:
        matmul.allow_bf16_reduced_precision_reduction = reduced
    return launches


def _recorded(fn):
    """Call ``fn()`` with ``models.moe.apply_moe`` recording each MoE
    call's top-1 expert per token (on the device) and the call's aux;
    returns (fn's result, [(routes [N], aux), ...] in call order)."""
    from repro_torch.models import moe
    seen, apply = [], moe.apply_moe

    def wrapper(p, x, **kw):
        y, aux = apply(p, x, **kw)
        seen.append((moe.route(p, x.reshape(-1, x.shape[-1]))[0], aux))
        return y, aux
    moe.apply_moe = wrapper
    try:
        return fn(), seen
    finally:
        moe.apply_moe = apply


def _agree(a, b, shape):
    """Positions [B, S] whose route is the same in every MoE call of two
    runs."""
    ok = None
    for (ra, _), (rb, _) in zip(a, b):
        eq = (ra == rb).reshape(shape)
        ok = eq if ok is None else ok & eq
    return ok


def _logit_gap(a, b, agree, rows=1024):
    """The largest |a - b| over the positions where ``agree`` (or all), a
    block of rows at a time (a full-vocabulary f32 copy would take 6.6
    GB)."""
    gap = 0.0
    for i in range(0, a.shape[1], rows):
        d = (a[:, i:i + rows].float() - b[:, i:i + rows].float()).abs()
        d = d.amax(-1)
        if agree is not None:
            d = d[agree[:, i:i + rows]]
        if d.numel():
            gap = max(gap, d.max().item())
    return gap


def _family_run(torch, arch, depth, n_want, attn_ms, fails,
                readings) -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import backend
    from repro_torch.launch import serve, steps
    from repro_torch.models import model as model_mod
    from repro_torch.models import transformer as tfm

    dev = torch.device('cuda')
    tag = f'families: {arch}'
    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    moe = cfg.n_experts > 0
    n_attn = (0 if not cfg.n_heads else len(tfm.hybrid_groups(cfg)) - 1
              if cfg.family == 'hybrid' else cfg.n_layers)
    impls = ('pallas', 'flash_jnp') if n_attn else ('flash_jnp',)
    models = {i: model_mod.build_model(dataclasses.replace(cfg, attn_impl=i))
              for i in impls}
    main = models[impls[0]]
    n = main.n_params()
    print(f'{tag}: {cfg.family}, {cfg.n_layers} layers'
          f'{f" (of {get_config(arch).n_layers})" if depth else ""}, '
          f'd_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of '
          f'{cfg.head_dim}, d_ff {cfg.d_ff}, experts {cfg.n_experts} (MoE '
          f'every {cfg.moe_every}), ssm state {cfg.ssm_state}, patches '
          f'{cfg.n_patches}, encoder layers {cfg.enc_layers} over '
          f'{cfg.enc_seq if cfg.enc_layers else 0} frames, causal attention '
          f'applications {n_attn}, vocab {cfg.vocab_size}, {cfg.dtype}: '
          f'{n:,} parameters')
    if n != n_want:
        fails.append(f'{tag}: {n:,} parameters, want {n_want:,}')
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    params = _measured_init(torch, readings, arch, lambda: main.init(
        torch.Generator(device=dev).manual_seed(0)))
    print(f'{tag}: init on the card {time.perf_counter() - t:.2f} s, '
          f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, '
          f'peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB')

    setup = steps.ServeSetup(main)
    batch = _family_batch(torch, setup, dev)
    shape = (PREFILL_B, PREFILL_S)
    backend.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    nxt = setup.prefill_step(params, batch)
    torch.cuda.synchronize()
    first = time.perf_counter() - t
    counts = dict(backend.LAUNCHES)
    out = {}
    if arch in FAMILY_ATTN:
        out[family_attn_record(arch)] = counts['swa_attention']
    others = {k: c for k, c in counts.items() if c and k != 'swa_attention'}
    if counts['swa_attention'] != n_attn or others:
        fails.append(f'{tag}: prefill_step launched swa_attention '
                     f'{counts["swa_attention"]} times (want {n_attn}), '
                     f'others {others}')
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        setup.prefill_step(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    rate = PREFILL_B * PREFILL_S / min(secs)
    # llama4-maverick's heads are llama4-scout's: the same record's time
    ms = attn_ms.get(family_attn_record(arch))
    share = (f'; kernel 21 {n_attn} launches x {ms:.4f} ms = '
             f'{n_attn * ms / 1e3 / min(secs):.1%} of it' if n_attn else '')
    print(f'{tag}: prefill_step [{PREFILL_B}, {PREFILL_S}] {impls[0]}: '
          f'first {first:.4f} s, then {[round(x, 4) for x in secs]} s '
          f'({rate:.0f} tokens/s){share}')
    profile_train(torch, f'{tag} profile (one prefill_step, {impls[0]})',
                  lambda: setup.prefill_step(params, batch))

    (lk, aux), rk = _recorded(lambda: main.logits(params, batch))
    if moe:
        drop = [round(a['dropped_frac'].item(), 4) for _, a in rk]
        print(f'{tag}: capacity factor {cfg.capacity_factor}: '
              f'load_balance_loss {aux["load_balance_loss"].item():.5f} '
              f'(summed over {len(rk)} MoE layers), dropped_frac by layer '
              f'{drop}')
    if not (tuple(lk.shape) == shape + (cfg.padded_vocab,)
            and bool(torch.isfinite(lk).all())
            and torch.equal(lk[:, -1].argmax(-1), nxt)):
        fails.append(f'{tag}: prefill logits {tuple(lk.shape)} not finite '
                     f'or not prefill_step\'s next tokens')
    del lk, rk

    # no drops from here on, as a decode step has none: a route alone
    # decides a token's expert
    tcfg = (dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
            if moe else cfg)
    tmodels = {i: model_mod.build_model(dataclasses.replace(tcfg,
                                                            attn_impl=i))
               for i in impls}
    if n_attn:
        torch.cuda.synchronize()
        t = time.perf_counter()
        nxt_flash = steps.ServeSetup(models['flash_jnp']).prefill_step(
            params, batch)
        torch.cuda.synchronize()
        flash_s = time.perf_counter() - t
        cmp = (dict(batch, tokens=batch['tokens'][:, :NODROP_S]) if moe
               else batch)
        (lp, _), rp = _recorded(lambda: tmodels['pallas'].logits(params,
                                                                 cmp))
        (lf, _), rf = _recorded(lambda: tmodels['flash_jnp'].logits(params,
                                                                    cmp))
        agree = _agree(rp, rf, tuple(cmp['tokens'].shape)) if moe else None
        flips = 0 if agree is None else int((~agree).sum())
        gap = _logit_gap(lp, lf, agree)
        last = True if agree is None else bool(agree[:, -1].all())
        same = torch.equal(lp[:, -1].argmax(-1), lf[:, -1].argmax(-1))
        print(f'{tag}: prefill_step flash_jnp {flash_s:.4f} s '
              f'({PREFILL_B * PREFILL_S / flash_s:.0f} tokens/s); next '
              f'tokens {nxt.tolist()} / {nxt_flash.tolist()} (capacity '
              f'factor {cfg.capacity_factor}); at capacity factor '
              f'{tcfg.capacity_factor} on {cmp["tokens"].numel()} tokens: '
              f'routes differ at {flips} positions (bound {ROUTE_FLIPS}); '
              f'logits pallas vs flash_jnp max abs gap {gap:.4e} at the '
              f'others (bound {PREFILL_GAP}; largest |logit| '
              f'{lf.abs().max().item():.3f}); last next token equal: '
              f'{same} (route agrees: {last})')
        if not (gap <= PREFILL_GAP and flips <= ROUTE_FLIPS
                and (same or not last)):
            fails.append(f'{tag}: pallas vs flash_jnp: gap {gap:.4e} (bound '
                         f'{PREFILL_GAP}), {flips} route flips (bound '
                         f'{ROUTE_FLIPS}), last next token equal {same}')
        del lp, lf, rp, rf

    prompt = dict(batch, tokens=batch['tokens'][:, :TEACHER_LEN])
    tmain = tmodels[impls[0]]
    if cfg.family == 'vlm':
        # forward_logits always prepends the patches, and a decode step
        # has no patch context (the reference's): nothing to hold the
        # decode to here; the CPU suite holds it to the reference's
        print(f'{tag}: teacher-forced Model.prefill not compared: '
              f'forward_logits prepends {cfg.n_patches} patches, the '
              f'decode has none')
    else:
        cache = tmain.init_cache(PREFILL_B, TEACHER_LEN, device=dev)
        if cfg.family == 'audio':
            cache = _fill_cross(tfm, params, cache, prompt['frame_embeds'],
                                cfg)
        (_, step), rd = _recorded(lambda: tmain.prefill(params, cache,
                                                        prompt['tokens']))
        n_moe = len(rd) // TEACHER_LEN
        for impl in impls:
            (full, _), rfw = _recorded(lambda: tmodels[impl].logits(params,
                                                                    prompt))
            agree = None
            if moe:
                by_layer = [(torch.stack([rd[t * n_moe + j][0]
                                          for t in range(TEACHER_LEN)], 1),
                             None) for j in range(n_moe)]
                agree = _agree(by_layer, rfw, (PREFILL_B, TEACHER_LEN))
            flips = 0 if agree is None else int((~agree).sum())
            diff = _logit_gap(step, full, agree)
            print(f'{tag}: teacher-forced Model.prefill vs '
                  f'forward_logits ({impl}) on {TEACHER_LEN} tokens: routes '
                  f'differ at {flips} (bound {TEACHER_FLIPS}); max abs diff '
                  f'{diff:.4e} at the others (tolerance {TEACHER_TOL})')
            if not (diff <= TEACHER_TOL and flips <= TEACHER_FLIPS):
                fails.append(f'{tag}: teacher-forced prefill vs '
                             f'forward_logits ({impl}) {diff:.4e} > '
                             f'{TEACHER_TOL} or {flips} route flips > '
                             f'{TEACHER_FLIPS}')
            del full
        del step, rd, cache
    del batch, prompt

    # greedy decode through ServeSetup.serve_step on serve.run's params
    # (the same seed and draws) and prompts
    B, P, G = SERVE['batch'], SERVE['prompt_len'], SERVE['gen']
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(0))
    cache = main.init_cache(B, P + G, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cache, logits = main.prefill(params, cache, prompts.to(dev))
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t
    tok = logits[:, -1].argmax(-1)
    greedy, dec = [tok], []
    for _ in range(G - 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cache, tok = setup.serve_step(params, cache, tok[:, None])
        torch.cuda.synchronize()
        dec.append(time.perf_counter() - t)
        greedy.append(tok)
    greedy = torch.stack(greedy, dim=1)
    step_ms = sum(dec) / len(dec) * 1e3
    print(f'{tag}: decode B {B}: Model.prefill {B}x{P} tokens {pre_s:.4f} s; '
          f'{G - 1} serve_steps {step_ms:.2f} ms a step (fastest '
          f'{min(dec) * 1e3:.2f}), {B * 1e3 / step_ms:.1f} tokens/s; ids '
          f'{greedy[0].tolist()}')
    if not (int(greedy.min()) >= 0
            and int(greedy.max()) < cfg.padded_vocab):
        fails.append(f'{tag}: greedy ids out of range {greedy.tolist()}')
    profile_train(torch, f'{tag} profile (one serve_step, B {B})',
                  lambda: setup.serve_step(params, cache, tok[:, None]))
    if cfg.family == 'audio':
        cross_padding(torch, tfm, params, cache, cfg, tag)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f'{tag}: peak device memory {peak:.3f} GiB')
    del params, cache, logits
    torch.cuda.empty_cache()

    if arch in SERVE_RUNS:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        toks = serve.run(arch, full_size=True, **SERVE)
        torch.cuda.synchronize()
        print(f'{tag}: serve.run({arch!r}, full_size=True, {SERVE}): '
              f'{time.perf_counter() - t:.2f} s wall; peak device memory '
              f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; ids '
              f'{toks[0].tolist()}')
        if not (tuple(toks.shape) == (B, G) and torch.equal(toks, greedy)):
            fails.append(f'{tag}: serve.run tokens {toks.tolist()} are not '
                         f'the serve_step greedy decode {greedy.tolist()}')
    return out


def cross_padding(torch, tfm, params, cache, cfg, tag):
    """What the blocking costs a whisper decode step (printed only): one
    decoder layer's ``cross_attn_block`` on a decode step's query against
    its cross caches, with the model's ``kv_block`` (the ``enc_seq`` keys
    padded to a multiple of it; the plain attention pads no query) and
    with one block of ``enc_seq`` keys, CUDA events."""
    import dataclasses
    xattn = tfm.layer_slice(params['dec_layers'], 0)['xattn']
    gen = torch.Generator(device='cuda').manual_seed(3)
    x = torch.randn((cache['xk'].shape[1], 1, cfg.d_model), generator=gen,
                    device='cuda').to(cfg.dtype)
    kv = (cache['xk'][0], cache['xv'][0])
    tight = dataclasses.replace(cfg, kv_block=cfg.enc_seq)
    ms = [_time_ms(torch, lambda c=c: tfm.cross_attn_block(xattn, x, kv, c),
                   3, 20) for c in (cfg, tight)]
    print(f'{tag}: cross-attention of one decode step, one layer: '
          f'{ms[0]:.4f} ms with kv_block {cfg.kv_block} (the '
          f'reference\'s), {ms[1]:.4f} ms with one block of {cfg.enc_seq} '
          f'keys; x {cfg.n_layers} layers: '
          f'{cfg.n_layers * (ms[0] - ms[1]):.3f} ms a step of blocking')


def _family_batch(torch, setup, dev):
    """The bulk prefill's batch on the card, shaped by
    ``setup.prefill_batch`` at B 1 x S 8192: seeded tokens and, for the
    VLM and the audio family, its patch or frame embeddings (the stubbed
    vision tower's and mel front end's outputs), 0.1 N(0, 1) in f32, all
    drawn by a CPU generator."""
    from repro_torch.configs import InputShape
    gen = torch.Generator().manual_seed(1)
    vocab = setup.model.cfg.vocab_size
    shape = InputShape('prefill', PREFILL_S, PREFILL_B, 'prefill')
    return {k: (torch.randint(0, vocab, m.shape, generator=gen)
                if k == 'tokens' else 0.1 * torch.randn(m.shape,
                                                        generator=gen)
                ).to(dev) for k, m in setup.prefill_batch(shape).items()}


def _fill_cross(tfm, params, cache, frames, cfg):
    """Whisper's ``xk``/``xv`` from the encoder's output, layer by layer,
    as the JAX package's test fills them (no entry point does)."""
    enc = tfm.encode(params, frames, cfg)
    for i in range(cfg.n_layers):
        layer = tfm.layer_slice(params['dec_layers'], i)
        cache['xk'][i], cache['xv'][i] = tfm.project_enc_kv(layer['xattn'],
                                                            enc, cfg)
    return cache


# ---------------------------------------------------------------------------
# Phase 13: federated LLM training (silo-mode SAFA)
# ---------------------------------------------------------------------------

#: the train phase's model: qwen3-1.7b at full width and depth (28 layers,
#: d_model 2048, 16/8 heads of 128, d_ff 6144, vocab 151,936)
TRAIN_ARCH = 'qwen3-1.7b'
#: the JAX CLI's defaults (``repro.launch.train.main``), rounds cut to 3
TRAIN_CLI = dict(rounds=3, n_clients=4, fraction=0.5, lag_tolerance=5,
                 crash_prob=0.2, batch=4, seq=64, local_steps=2, lr=0.05)
#: the compute-heavy round: INPUT_SHAPES['train_4k']'s sequence length with
#: its global batch cut from 256 to 4 (one sequence a client), SiloSetup's
#: one local step, remat on
LONG_BATCH = 4
#: test_system.py's masks of a four-client round
TRAIN_MASKS = {'sync': [1, 1, 0, 1], 'picked': [1, 0, 0, 1],
               'undrafted': [0, 1, 0, 0], 'deprecated': [0, 0, 1, 0],
               'completed': [1, 1, 0, 1]}
TRAIN_WEIGHTS = [0.3, 0.3, 0.2, 0.2]
#: depth of the in-place against out-of-place check (of 28 layers)
CUT_DEPTH = 4
#: bounds of one client batch's bf16 loss and gradient against an f32
#: recompute of the same params on the card: |loss - f32 loss| and the
#: least cosine of a gradient leaf with its f32 twin (on an H100 before
#: the final run: 0.00019 and 0.99967)
F32_LOSS_GAP, F32_GRAD_COS = 0.01, 0.999
SGD_CHECK_STEPS = 8     # SGD steps on one fixed batch that must lower it


def train_phase(torch, fails: list, readings: dict) -> dict:
    """Silo-mode SAFA over qwen3-1.7b at full width and depth, then
    mamba2-130m, through the port's training entry points (``train.run``,
    ``SiloSetup.train_step``), random init on the card, bf16, with bf16
    products reduced in f32 (as the reference accumulates) and TF32 off.
    No kernel lies on this path: the phase holds every launch count at
    0 (training runs ``attn_impl='flash_jnp'``; the kernels refuse a
    gradient).  Returns {}."""
    from repro_torch.kernels import backend
    matmul = torch.backends.cuda.matmul
    saved = (matmul.allow_bf16_reduced_precision_reduction,
             matmul.allow_tf32)
    matmul.allow_bf16_reduced_precision_reduction = False
    matmul.allow_tf32 = False
    backend.reset_launches()
    try:
        _train_runs(torch, fails, readings)
    finally:
        (matmul.allow_bf16_reduced_precision_reduction,
         matmul.allow_tf32) = saved
    launched = {k: v for k, v in backend.LAUNCHES.items() if v}
    print(f'train: kernel launches {launched or 0}')
    if launched:
        fails.append(f'train: the training path launched kernels {launched}')
    return {}


def _silo_timers(torch, steps):
    """Time ``SiloSetup.train_step`` (the round) and
    ``SiloSetup.train_clients`` (its local training), synchronised;
    returns (times, restore)."""
    cls = steps.SiloSetup
    saved = cls.train_step, cls.train_clients
    times = {'round': [], 'train': []}

    def timed(fn, key):
        def wrapper(self, *args, **kwargs):
            return _timed(torch, lambda: fn(self, *args, **kwargs),
                          times[key])()
        return wrapper
    cls.train_step = timed(saved[0], 'round')
    cls.train_clients = timed(saved[1], 'train')

    def restore():
        cls.train_step, cls.train_clients = saved
    return times, restore


def _report_rounds(torch, label, times, tokens, fails):
    """Per-round train and server-step seconds, trained tokens/s and the
    peak device memory since the last reset."""
    peak = torch.cuda.max_memory_allocated() / 2**30
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    for r, (whole, tr) in enumerate(zip(times['round'], times['train'])):
        print(f'{label}: round {r + 1} {whole:.4f} s: local train '
              f'{tr:.4f} s, server step {whole - tr:.4f} s; '
              f'{tokens / tr:,.0f} trained tokens/s')
    print(f'{label}: peak device memory {peak:.3f} GiB of {total:.1f}')
    if peak >= total:
        fails.append(f'{label}: peak memory {peak:.1f} GiB >= the card\'s '
                     f'{total:.1f} GiB')


def _finite(label, losses, fails):
    if not all(math.isfinite(x) for x in losses):
        fails.append(f'{label}: a loss is not finite: {losses}')


def _train_runs(torch, fails: list, readings: dict) -> None:
    import dataclasses
    import os
    import shutil
    import tempfile

    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.core import protocol
    from repro_torch.launch import steps, train
    from repro_torch.models.model import build_model
    from repro_torch.optim import tree_leaves, tree_map

    dev = torch.device('cuda')
    cli = TRAIN_CLI
    C, steps_n = cli['n_clients'], cli['local_steps']
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    print(f'train: {TRAIN_ARCH} at full width and depth: {cfg.n_layers} '
          f'layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} '
          f'heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab '
          f'{cfg.vocab_size}, {model.n_params():,} parameters, remat '
          f'{cfg.remat}')

    # (1) train.run at the JAX CLI's defaults, saving its checkpoint
    times, restore = _silo_timers(torch, steps)
    ckpt_dir = tempfile.mkdtemp(prefix='chip_smoke_llm_')
    ckpt = os.path.join(ckpt_dir, 'qwen3.npz')
    saved, save_s = {}, []
    save = train.checkpoint.save

    def keep(path, tree, meta):
        saved['global'] = tree
        return save(path, tree, meta)
    train.checkpoint.save = _timed(torch, keep, save_s)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        hist = train.run(TRAIN_ARCH, full_size=True, device='cuda',
                         log_every=1, ckpt=ckpt, **cli)
    finally:
        restore()
        train.checkpoint.save = save
    print(f'train: train.run {time.perf_counter() - t0:.1f} s wall '
          f'(init and checkpoint included), losses {hist}')
    _finite('train: qwen3 train.run', hist, fails)
    _report_rounds(torch, 'train: qwen3 S 64', times,
                   C * steps_n * cli['batch'] * cli['seq'], fails)
    readings['round_s'] = times['round'][1:]   # round 1 carries set-up
    # (d) of phase 15: serve the checkpoint at full size
    try:
        checkpoint_llm(torch, ckpt, saved.pop('global'), save_s[0], fails)
    finally:
        shutil.rmtree(ckpt_dir)
    torch.cuda.empty_cache()

    # (2) one round at train_4k's sequence length, and profiles
    shape = INPUT_SHAPES['train_4k']
    S = shape.seq_len
    setup = steps.SiloSetup(model, n_clients=C, local_steps=1,
                            learning_rate=cli['lr'])
    print(f'train: S {S} round: global batch cut from '
          f'{shape.global_batch} to {LONG_BATCH} ({LONG_BATCH // C} '
          f'sequence a client), local steps 1, remat {cfg.remat}')
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    state = _measured_init(torch, readings, STATE_LABEL,
                           lambda: setup.init_state(model.init(gen)))

    def round_batch(b, seq, seed, vocab=cfg.vocab_size):
        g = torch.Generator(device=dev).manual_seed(seed)
        toks = torch.randint(0, vocab, (C, b, seq + 1),
                             generator=g, device=dev, dtype=torch.int32)
        meta = {k: torch.tensor(v, dtype=torch.bool, device=dev)
                for k, v in TRAIN_MASKS.items()}
        meta['weights'] = torch.tensor(TRAIN_WEIGHTS, device=dev)
        return {'tokens': toks[..., :-1].contiguous(),
                'labels': toks[..., 1:].contiguous(), 'meta': meta}

    long_batch = round_batch(LONG_BATCH // C, S, 1)
    times, restore = _silo_timers(torch, steps)
    try:
        state, m = setup.train_step(state, long_batch)
    finally:
        restore()
    long_loss = float(m['loss'])
    print(f'train: S {S} round loss {long_loss:.4f}')
    _finite(f'train: S {S} round', [long_loss], fails)
    _report_rounds(torch, f'train: qwen3 S {S}', times, LONG_BATCH * S,
                   fails)
    prof = profile_train(torch, f'train: qwen3 S {S}, one client step',
                         lambda: setup.train_client(steps.row(
                             state['local'], 0), setup.client(long_batch, 0)))
    if prof:
        print(f'train: qwen3 S {S}: {prof[2]:,} launches a client step')
    del long_batch

    # the S 64 round's profiles: busy share of a round, launches a step
    short = round_batch(cli['batch'], cli['seq'], 2)
    setup2 = steps.SiloSetup(model, n_clients=C, local_steps=steps_n,
                             learning_rate=cli['lr'])
    _round_profiles(torch, 'train: qwen3 S 64', setup2, state, short)
    del state
    torch.cuda.empty_cache()

    # (3) checks on one client batch of fresh params
    params = model.init(torch.Generator(device=dev).manual_seed(3))
    cb = setup.client(short, 0)

    def loss_and_grads(mdl, p):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(), p)
        loss = mdl.loss(p, cb)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        return float(loss.detach()), grads

    loss16, g16 = loss_and_grads(model, params)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    loss32, g32 = loss_and_grads(build_model(cfg32),
                                 tree_map(lambda t: t.float(), params))
    cos = [float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.flatten(), dim=0)) for a, b in zip(g16, g32)]
    names = ['.'.join(p) for p in _tree_paths(params)]
    worst = min(range(len(cos)), key=cos.__getitem__)
    print(f'train: bf16 against f32 on one client batch: loss {loss16:.5f} '
          f'vs {loss32:.5f} (gap {abs(loss16 - loss32):.5f}, bound '
          f'{F32_LOSS_GAP}); gradient cosine min {cos[worst]:.5f} '
          f'({names[worst]}, bound {F32_GRAD_COS}), per leaf '
          + ', '.join(f'{n} {c:.4f}' for n, c in zip(names, cos)))
    if abs(loss16 - loss32) > F32_LOSS_GAP or cos[worst] < F32_GRAD_COS:
        fails.append('train: the bf16 loss or gradient is off its f32 '
                     'recompute')
    del g16, g32

    sgd = steps.SiloSetup(model, n_clients=1, local_steps=1,
                          learning_rate=cli['lr'])
    losses, p = [], params
    for _ in range(SGD_CHECK_STEPS):
        p, loss = sgd.train_client(p, cb)
        losses.append(float(loss))
    with torch.no_grad():
        losses.append(float(model.loss(p, cb)))
    print(f'train: {SGD_CHECK_STEPS} SGD steps on one batch: losses '
          + ', '.join(f'{x:.4f}' for x in losses))
    _finite('train: SGD steps', losses, fails)
    if not losses[-1] < losses[0]:
        fails.append(f'train: {SGD_CHECK_STEPS} SGD steps did not lower '
                     f'the batch\'s loss: {losses[0]} -> {losses[-1]}')
    del p, params
    torch.cuda.empty_cache()

    cut = build_model(dataclasses.replace(cfg, n_layers=CUT_DEPTH))
    cut_setup = steps.SiloSetup(cut, n_clients=C, local_steps=steps_n,
                                learning_rate=cli['lr'])
    state = cut_setup.init_state(
        cut.init(torch.Generator(device=dev).manual_seed(4)))
    meta = short['meta']

    def per_client(base):
        rows = [cut_setup.train_client(steps.row(base, k),
                                       cut_setup.client(short, k))[0]
                for k in range(C)]
        return tree_map(lambda *r: torch.stack(r), *rows)
    want = protocol.safa_round(
        state['global'], state['local'], state['cache'],
        sync_mask=meta['sync'], completed=meta['completed'],
        picked=meta['picked'], undrafted=meta['undrafted'],
        deprecated=meta['deprecated'], weights=meta['weights'],
        local_train_fn=per_client)
    got, _ = cut_setup.train_step(state, short)
    ulps = [_max_ulps(torch, a, b)
            for part, ref in zip(('global', 'local', 'cache'), want)
            for a, b in zip(tree_leaves(got[part]), tree_leaves(ref))]
    print(f'train: in-place train_step against protocol.safa_round at '
          f'{CUT_DEPTH} of {cfg.n_layers} layers: max {max(ulps)} ulp over '
          f'{len(ulps)} leaves of global, local and cache (want 0)')
    if max(ulps):
        fails.append('train: the in-place silo step differs from the '
                     'out-of-place composition')
    del state, got, want
    torch.cuda.empty_cache()

    # (4) mamba2-130m at full width through train.run
    times, restore = _silo_timers(torch, steps)
    torch.cuda.reset_peak_memory_stats()
    try:
        hist = train.run('mamba2-130m', full_size=True, device='cuda',
                         log_every=1, **cli)
    finally:
        restore()
    print(f'train: mamba2-130m losses {hist}')
    _finite('train: mamba2 train.run', hist, fails)
    _report_rounds(torch, 'train: mamba2 S 64', times,
                   C * steps_n * cli['batch'] * cli['seq'], fails)
    mamba = build_model(get_config('mamba2-130m'))
    setup = steps.SiloSetup(mamba, n_clients=C, local_steps=steps_n,
                            learning_rate=cli['lr'])
    _round_profiles(torch, 'train: mamba2 S 64', setup, setup.init_state(
        mamba.init(torch.Generator(device=dev).manual_seed(0))),
        round_batch(cli['batch'], cli['seq'], 5, mamba.cfg.vocab_size))
    torch.cuda.empty_cache()


def _round_profiles(torch, label, setup, state, batch):
    """The device busy share of one ``train_step`` round on ``batch``
    (``state`` is consumed), then the launches of one client step: a
    trace of client 0's ``train_client`` over its local steps."""
    from repro_torch.launch import steps

    holder = {}

    def one_round():
        holder['state'], _ = setup.train_step(state, batch)
    profile_train(torch, f'{label}, one round', one_round)
    if 'state' not in holder:       # the profiler failed before the round
        one_round()
    local = holder.pop('state')['local']
    prof = profile_train(torch, f'{label}, one client',
                      lambda: setup.train_client(steps.row(local, 0),
                                                 setup.client(batch, 0)))
    if prof:
        print(f'{label}: {prof[2] / setup.local_steps:,.0f} launches a '
              f'client step')


def _tree_paths(tree, prefix=()):
    """Key paths of a nested dict's leaves, in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _tree_paths(v, prefix + (k,)) if isinstance(v, dict) \
            else [prefix + (k,)]
    return out


def _max_ulps(torch, a, b) -> int:
    """The largest distance of two same-dtype float tensors in units in
    the last place (0: bit for bit)."""
    if torch.equal(a, b):
        return 0
    ints = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32}[a.dtype]

    def ordered(t):
        i = t.contiguous().view(ints).long()
        return torch.where(i < 0, -(i & (2 ** (8 * t.element_size() - 1)
                                         - 1)), i)
    return int((ordered(a) - ordered(b)).abs().max())


def one_epoch(task):
    """A shallow copy of ``task`` that trains one epoch of its five: the
    profiles' window.  A whole fleet train call launches ~350,000 device
    kernels, and reading them back from the profiler took minutes of the
    script's time limit; one epoch is the same steps, a fifth as many."""
    import copy
    one = copy.copy(task)
    one.epochs = 1
    return one


def profile_train(torch, label, train, top=6):
    """Where one call spends the device (one round's local training, a
    serving step): torch.profiler traces the card over one ``train()``
    call, and the trace is written as a Chrome trace (in C++) and read
    back as JSON, which takes seconds for the hundreds of thousands of
    kernels of a training step where building the profiler's Python
    events takes minutes.  The busy share is the union of the device
    intervals (kernels, copies, sets) over the call's wall time, so
    kernels that overlap count once.  Returns (wall s, busy s, kernels),
    or None when not measured: a measurement only, a profiler that
    cannot trace the card leaves the other phases' verdict alone."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                train()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            path = pathlib.Path(tmp) / 'trace.json'
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text())['traceEvents']
    except Exception as e:  # noqa: BLE001 - report and go on
        print(f'{label}: not measured ({e!r})')
        return None
    spans = sorted((float(e['ts']), float(e['ts']) + float(e['dur']),
                    e['cat'], e['name']) for e in events
                   if e.get('ph') == 'X' and e.get('cat') in (
                       'kernel', 'gpu_memcpy', 'gpu_memset'))
    if not spans:
        print(f'{label}: not measured (the trace holds no device kernels)')
        return None
    busy, reach = 0.0, spans[0][0]
    by_name = {}
    for start, stop, _, name in spans:
        busy += max(0.0, stop - max(start, reach))
        reach = max(reach, stop)
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + stop - start, n + 1)
    kernels = sum(cat == 'kernel' for _, _, cat, _ in spans)
    summed = sum(tot for tot, _ in by_name.values()) / 1e6
    print(f'{label}: one call {wall:.3f} s wall; device busy '
          f'{busy / 1e6:.3f} s ({busy / 1e6 / wall:.1%}) as the union of '
          f'{len(spans)} device spans ({kernels} kernels, {summed:.3f} s '
          f'summed), {len(by_name)} names')
    for name, (tot, n) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][0])[:top]:
        print(f'{label}:   {tot / 1e3:9.1f} ms {n:6d}x  {name[:90]}')
    return wall, busy / 1e6, kernels


# ---------------------------------------------------------------------------
# Phase 14: the dry run (every architecture x input shape on ``meta``)
# ---------------------------------------------------------------------------

#: the label of the train phase's measured state (qwen3-1.7b, C = 4)
STATE_LABEL = 'qwen3-1.7b silo state, C = 4'
#: allocator rounding allowed between the dry run's bytes and a measured
#: init, per leaf
ROUND_BYTES = 512
#: how long the dry-run phase waits for its two processes, seconds
DRYRUN_WAIT = 400


def new_readings() -> dict:
    """What phases 11-13 record for the dry-run phase: 'init' (label ->
    (``memory_allocated`` after less before, requested bytes after less
    before or None) of each measured init), 'prefill_s' (the serve
    phase's timed ``prefill_step`` calls), 'round_s' (the train phase's
    qwen3 S 64 rounds after the first)."""
    return {'init': {}, 'prefill_s': None, 'round_s': None}


def _requested(torch):
    return torch.cuda.memory_stats().get('requested_bytes.all.current')


def _allocator(torch, setting: str):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', FutureWarning)
        torch.cuda.memory._set_allocator_settings(setting)


def _measured_init(torch, readings, label, init):
    """``init()``, recording in ``readings['init'][label]`` the device
    memory it leaves allocated.  Expandable segments are on for the call, so the
    allocator splits every block down to its request rounded up to 512 B
    (without them a large block is kept whole when the rest would be 1
    MiB or less, and ``memory_allocated`` counts that rest)."""
    torch.cuda.synchronize()
    _allocator(torch, 'expandable_segments:True')
    try:
        a0, r0 = torch.cuda.memory_allocated(), _requested(torch)
        out = init()
        torch.cuda.synchronize()
        a1, r1 = torch.cuda.memory_allocated(), _requested(torch)
    finally:
        _allocator(torch, 'expandable_segments:False')
    readings['init'][label] = (a1 - a0, None if r0 is None else r1 - r0)
    return out


def start_dryruns(src: pathlib.Path) -> list:
    """Start ``python -m repro_torch.launch.dryrun --all`` on the one-pod
    and the two-pod production mesh, each in a process of its own on the
    host (the dry run runs on the ``meta`` device, never on the card),
    beside the card's phases.  Returns [(mesh label, process, rows file,
    errors file, start time)]."""
    import os
    import tempfile
    tmp = pathlib.Path(tempfile.mkdtemp(prefix='chip_smoke_dryrun_'))
    env = dict(os.environ, PYTHONPATH=str(src.resolve()),
               OMP_NUM_THREADS='1')
    runs = []
    for label, flags in (('one pod', []), ('two pods', ['--multi-pod'])):
        out = tmp / f'{len(runs)}.jsonl'
        err = tmp / f'{len(runs)}.err'
        with open(out, 'w') as fo, open(err, 'w') as fe:
            proc = subprocess.Popen(
                [sys.executable, '-m', 'repro_torch.launch.dryrun', '--all',
                 *flags], stdout=fo, stderr=fe, env=env)
        runs.append((label, proc, out, err, time.time()))
    return runs


def stop_dryruns(runs) -> None:
    """Kill any dry-run process still running; remove their files."""
    import shutil
    for _, proc, out, _, _ in runs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(out.parent, ignore_errors=True)


def dryrun_phase(torch, runs, readings: dict, fails: list) -> None:
    """Phase 14: the dry run's rows for all 33 cells on both production
    meshes (one line a cell: trace seconds, argument bytes whole and per
    chip, whether the arguments alone fit one card beside this card's
    memory, the roofline on the mesh); the dry run's parameter and state
    bytes held against each measured init; the serve phase's prefill and
    the train phase's S 64 rounds as shares of their one-card rooflines
    (readings, not gates)."""
    from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                     shape_supported)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    total = torch.cuda.get_device_properties(0).total_memory
    cells = {(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
             if shape_supported(a, s)}
    rows = {}
    for label, proc, out, err, started in runs:
        t = time.perf_counter()
        try:
            rc = proc.wait(timeout=DRYRUN_WAIT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = f'killed after {DRYRUN_WAIT} s'
        waited = time.perf_counter() - t
        got = [json.loads(line) for line in out.read_text().splitlines()
               if line.startswith('{')]
        errors = err.read_text().strip()
        print(f'dryrun: {label}: exit {rc}, {len(got)} rows, the last '
              f'written {out.stat().st_mtime - started:.1f} s after the '
              f'process started ({sum(r["trace_s"] for r in got):.1f} s '
              f'tracing); waited {waited:.1f} s here'
              + (f'; stderr:\n{errors[-3000:]}' if errors else ''))
        if rc != 0 or {(r['arch'], r['shape']) for r in got} != cells \
                or len(got) != len(cells):
            fails.append(f'dryrun: {label}: exit {rc}, {len(got)} rows of '
                         f'{len(cells)} cells')
        for r in got:
            rows[(r['arch'], r['shape'], r['mesh'])] = r
            print(f'dryrun: {r["arch"]} {r["shape"]} on {r["mesh"]}: '
                  f'traced in {r["trace_s"]:.2f} s; arguments '
                  f'{r["whole_arg_bytes"] / 2**30:.3f} GiB whole, '
                  f'{r["arg_bytes"] / 2**30:.4f} GiB a chip; fits one card '
                  f'(arguments <= 80 GB): {r["fits_one_card"]} (this card '
                  f'{total / 2**30:.2f} GiB); params '
                  f'{r["param_bytes"] / 2**30:.3f} GiB; roofline on '
                  f'{r["chips"]} chips: compute {r["t_compute_s"]:.4e} s, '
                  f'memory {r["t_memory_s"]:.4e} s ({r["bottleneck"]})')

    one = Mesh((1, 1), ('data', 'model'))
    prefill = dryrun.lower_one(ARCH, InputShape('prefill', PREFILL_S,
                                                PREFILL_B, 'prefill'),
                               mesh=one)
    cli = TRAIN_CLI
    C = cli['n_clients']
    rnd = dryrun.lower_one(TRAIN_ARCH, InputShape(
        'round', cli['seq'], C * cli['batch'], 'train'), mesh=one,
        n_clients=C, local_steps=cli['local_steps'])
    # bytes and leaves each measured init should hold
    want = {ARCH: (prefill['param_bytes'], prefill['n_param_leaves']),
            STATE_LABEL: (rnd['state_bytes'], 3 * rnd['n_param_leaves'])}
    for arch, depth, _ in FAMILIES:
        if depth:
            r = dryrun.lower_one(arch, 'decode_32k',
                                 extra_cfg={'n_layers': depth})
            whole = rows.get((arch, 'decode_32k', 'data=16xmodel=16'))
            if whole:
                print(f'dryrun: {arch} at its published depth: params '
                      f'{whole["param_bytes"] / 2**30:.2f} GiB '
                      f'({whole["n_params"]:,} parameters); at {depth} '
                      f'layers {r["param_bytes"] / 2**30:.2f} GiB')
        else:
            r = rows.get((arch, 'decode_32k', 'data=16xmodel=16'))
        if r:
            want[arch] = (r['param_bytes'], r['n_param_leaves'])
    for label, (dry, leaves) in want.items():
        if label not in readings['init']:
            fails.append(f'dryrun: no measured init of {label}')
            continue
        alloc, req = readings['init'][label]
        ok = 0 <= alloc - dry <= ROUND_BYTES * leaves
        print(f'dryrun: {label}: dry run {dry:,} B ({dry / 2**30:.3f} GiB, '
              f'{leaves} leaves); memory_allocated around its init '
              f'{alloc:,} B (+{alloc - dry:,}, bound +{ROUND_BYTES} x '
              f'{leaves} = {ROUND_BYTES * leaves:,}); requested '
              f'{"not measured" if req is None else f"{req:,} B"}: '
              f'{"ok" if ok else "MISMATCH"}')
        if not ok:
            fails.append(f'dryrun: {label}: measured {alloc:,} B against '
                         f'the dry run\'s {dry:,} B')

    for label, row, secs in (
            (f'{ARCH} prefill_step B {PREFILL_B} x S {PREFILL_S}', prefill,
             readings['prefill_s']),
            (f'{TRAIN_ARCH} S {cli["seq"]} round (C {C}, B {cli["batch"]}, '
             f'{cli["local_steps"]} local steps)', rnd,
             readings['round_s'])):
        bound = max(row['t_compute_s'], row['t_memory_s'])
        print(f'dryrun: {label}: one-card roofline {bound:.4e} s '
              f'({row["bottleneck"]}; compute {row["t_compute_s"]:.4e} s, '
              f'memory {row["t_memory_s"]:.4e} s; {row["flops"]:.4e} FLOP, '
              f'{row["hbm_bytes"]:.4e} B); measured '
              + (', '.join(f'{s:.4f} s = {bound / s:.2%}' for s in secs)
                 if secs else 'not measured'))


# ---------------------------------------------------------------------------
# Phase 15: checkpoint and resume; wire-derived comm
# ---------------------------------------------------------------------------

#: rounds of each checkpointed run, evaluated and saved every round: one
#: segment before the stop, one after the resume
CKPT_ROUNDS = 2
#: the serving defaults of ``repro_torch.launch.serve.main``
SERVE_CLI = dict(batch=4, prompt_len=32, gen=16)


def checkpoint_phase(torch, fails: list) -> dict:
    """Checkpoint and resume on Task 2's CNN at full width through
    ``run(checkpoint=, max_segments=)`` and ``run_sweep(...)``: (a) a SAFA
    run on the int8 wire with ``use_kernel='packed'``, (b) a 2-member
    fleet sweep of it, (c) an m = 1000 ``'sparse_tier'`` packed int8 run;
    each stopped after its first round and resumed on a fresh Experiment,
    which must end bit for bit as the uninterrupted run and launch its
    kernels for one round only.  Then (e) one ``EnvSpec(comm='wire')``
    run.  (d), the qwen3-1.7b checkpoint, runs in the train phase, where
    ``train.run`` writes it.  Trains with deterministic cuDNN.  Returns
    {}: the kernels' launches stand in the phases that drive their
    paths."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _checkpoint_runs(torch, fails)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {}


def _checkpoint_runs(torch, fails: list) -> None:
    from repro_torch import api

    safa = api.SafaSpec(fraction=0.3, lag_tolerance=5)
    q8 = dict(wire='int8', use_kernel='packed', eval_every=1)
    spec, task = cnn_setup(torch)

    def run(**kw):
        return api.Experiment(task, spec, safa, api.ExecSpec(**q8),
                              rounds=CKPT_ROUNDS).compile().run(**kw)
    _resume_check(torch, 'run, int8 packed', run, fails)

    def sweep(**kw):
        members = [api.SweepMember(env=spec, fraction=0.3, lag_tolerance=5,
                                   seed=s, overrides={'crash_prob': cr})
                   for s, cr in enumerate(FLEET_CRASH[:2])]
        return api.Experiment(task, None, safa, api.ExecSpec(
            engine='fleet', **q8), rounds=CKPT_ROUNDS).compile().run_sweep(
                members, **kw)
    _resume_check(torch, 'fleet sweep of 2, int8 packed', sweep, fails)
    _wire_check(torch, spec, task, safa, fails)
    del task
    torch.cuda.empty_cache()

    tier_spec, tier_task = cnn_setup(torch, scale_spec())
    tier_safa = api.SafaSpec(fraction=QUOTA / SCALE_M,
                             lag_tolerance=10 * CKPT_ROUNDS)

    def tier(**kw):
        return api.Experiment(tier_task, tier_spec, tier_safa, api.ExecSpec(
            schedule='sparse_tier', **q8), rounds=CKPT_ROUNDS
            ).compile().run(**kw)
    _resume_check(torch, f'm {SCALE_M} sparse_tier, int8 packed', tier,
                  fails)
    del tier_task
    torch.cuda.empty_cache()


def _resume_check(torch, label, call, fails) -> None:
    """``call()`` uninterrupted, then ``call(checkpoint=p,
    max_segments=1)`` and ``call(checkpoint=p)`` (each call a fresh
    Experiment), every launch counter at 0 before each: the resumed
    evals and final models must equal the uninterrupted run's bit for
    bit, and each half must launch exactly half of the whole run's
    kernels.  Prints the seconds of each call, of ``save_run`` and
    ``load_run``, and the file's bytes."""
    import os
    import shutil
    import tempfile

    from repro_torch import checkpoint
    from repro_torch.kernels import backend

    tag = f'checkpoint[{label}]'
    tmp = tempfile.mkdtemp(prefix='chip_smoke_ckpt_')
    path = os.path.join(tmp, 'run')
    saved = checkpoint.save_run, checkpoint.load_run
    save_s, load_s = [], []
    checkpoint.save_run = _timed(torch, saved[0], save_s)
    checkpoint.load_run = _timed(torch, saved[1], load_s)

    def counted(**kw):
        backend.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = call(**kw)
        torch.cuda.synchronize()
        return (out if isinstance(out, list) else [out],
                time.perf_counter() - t,
                {c: v for c, v in backend.LAUNCHES.items() if v})
    try:
        full, t_full, n_full = counted()
        part, t_part, n_part = counted(checkpoint=path, max_segments=1)
        nbytes = os.path.getsize(path + '.npz')
        res, t_res, n_res = counted(checkpoint=path)
    finally:
        checkpoint.save_run, checkpoint.load_run = saved
        shutil.rmtree(tmp)
    diff = max(_max_diff(a.final_global, b.final_global)
               for a, b in zip(res, full))
    same = all(torch.equal(a.final_global[k], b.final_global[k])
               for a, b in zip(res, full) for k in b.final_global)
    evals_same = [h.evals() for h in res] == [h.evals() for h in full]
    half = {c: v // 2 for c, v in n_full.items()}
    print(f'{tag}: uninterrupted {t_full:.2f} s ({CKPT_ROUNDS} rounds); '
          f'stopped after round 1 {t_part:.2f} s; resumed {t_res:.2f} s; '
          f'file {nbytes:,} B; save_run {[round(v, 4) for v in save_s]} s, '
          f'load_run {[round(v, 4) for v in load_s]} s; launches {n_full} '
          f'/ {n_part} / {n_res}; eval losses '
          f'{[[e["loss"] for _, e in h.evals()] for h in res]}; resumed - '
          f'uninterrupted final_global max abs diff {diff:.3e} (want 0: the '
          f'same bits), evals {"equal" if evals_same else "DIFFER"}')
    if not (same and evals_same):
        fails.append(f'{tag}: the resumed run differs from the '
                     f'uninterrupted one (final_global max abs diff '
                     f'{diff:.3e}, evals equal {evals_same})')
    if not n_full or any(v % 2 for v in n_full.values()) or \
            n_part != half or n_res != half:
        fails.append(f'{tag}: launches {n_full} uninterrupted, {n_part} '
                     f'stopped, {n_res} resumed; want one round each, '
                     f'{half}')
    if len(save_s) != CKPT_ROUNDS or len(load_s) != 1:
        fails.append(f'{tag}: {len(save_s)} saves and {len(load_s)} loads, '
                     f'want {CKPT_ROUNDS} and 1')


def _wire_check(torch, spec, task, safa, fails) -> None:
    """(e) One ``EnvSpec(comm='wire')`` run of one round on the int8 wire
    (packed): the model's bytes measured on each wire set its comm times.
    Prints the uplink and downlink megabytes on both wires (read back
    from the envs' per-round timing) and round 1's length beside the
    static comm model's."""
    from repro_torch import api
    from repro_torch.kernels import backend

    wired = spec.replace(comm='wire')
    mbs = {}
    for wire in ('f32', 'int8'):
        env = api.Experiment(task, wired, safa, api.ExecSpec(
            wire=wire, numeric=False), rounds=1).env
        timing = env.round_timing(1)
        mbs[wire] = tuple(float(t[0, 0]) * env.client_bw_mbps / 8.0
                          for t in (timing.t_up, timing.t_down))
        print(f'wire[{wire}]: uplink {mbs[wire][0]:.6f} MB, downlink '
              f'{mbs[wire][1]:.6f} MB a client a round (comm=\'wire\'; '
              f'static model_size_mb {spec.model_size_mb})')
    if not mbs['int8'][0] < mbs['f32'][0] / 3 or \
            mbs['int8'][1] != mbs['f32'][1]:
        fails.append(f'wire: int8 uplink {mbs["int8"][0]} MB not under a '
                     f'third of f32\'s {mbs["f32"][0]}, or the downlinks '
                     f'differ')
    ex = dict(wire='int8', use_kernel='packed', eval_every=1)
    backend.reset_launches()
    hist = api.Experiment(task, wired, safa, api.ExecSpec(**ex),
                          rounds=1).compile().run()
    counts = {c: v for c, v in backend.LAUNCHES.items() if v}
    static = api.Experiment(task, spec, safa, api.ExecSpec(**ex),
                            rounds=1).precompute()
    loss = hist.evals()[0][1]['loss']
    print(f'wire: comm=\'wire\' int8 run, 1 round: round_len '
          f'{hist.records[0].round_len:.4f} s (static comm '
          f'{static.records[0].round_len:.4f} s); launches {counts}; eval '
          f'loss {loss}')
    if not counts or not math.isfinite(loss):
        fails.append(f'wire: the comm=\'wire\' run launched {counts}, eval '
                     f'loss {loss}')


def checkpoint_llm(torch, path, trained: dict, save_s: float, fails: list
                   ) -> None:
    """(d) ``serve.run`` at full size from the checkpoint that
    ``train.run`` wrote at ``path``: every restored leaf must equal the
    trained global's bit for bit (bf16 compared as int16).  Prints the
    file's bytes, the free space beside it, and the seconds to save and
    to restore.  Deletes the file."""
    import os
    import shutil

    from repro_torch import checkpoint
    from repro_torch.launch import serve

    nbytes = os.path.getsize(path)
    free = shutil.disk_usage(os.path.dirname(path)).free
    got, load_s = {}, []
    restore = serve.checkpoint.restore

    def keep(*args, **kwargs):
        out = restore(*args, **kwargs)
        got['params'] = out[0]
        return out
    serve.checkpoint.restore = _timed(torch, keep, load_s)
    try:
        t = time.perf_counter()
        toks = serve.run(TRAIN_ARCH, full_size=True, ckpt=path,
                         device='cuda', **SERVE_CLI)
        wall = time.perf_counter() - t
    finally:
        serve.checkpoint.restore = restore
        os.remove(path)

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    want, have = checkpoint.flatten(trained), checkpoint.flatten(
        got['params'])
    differ = sorted(k for k in want if k not in have or not (
        have[k].dtype == want[k].dtype and have[k].shape == want[k].shape
        and torch.equal(bits(have[k]), bits(want[k]))))
    n = sum(v.numel() for v in want.values())
    print(f'checkpoint[{TRAIN_ARCH}]: {len(want)} leaves, {n:,} parameters, '
          f'{sorted({str(v.dtype) for v in want.values()})}; file '
          f'{nbytes:,} B ({nbytes / 1e9:.3f} GB), free beside it '
          f'{free / 1e9:.1f} GB; save {save_s:.2f} s, restore '
          f'{load_s[0]:.2f} s; serve.run({SERVE_CLI}) {wall:.2f} s, ids '
          f'{toks[0].tolist()}; restored leaves equal to the trained global '
          f'bit for bit: {len(want) - len(differ)} of {len(want)}')
    if differ or sorted(have) != sorted(want):
        fails.append(f'checkpoint[{TRAIN_ARCH}]: restored leaves differ from '
                     f'the trained global: {differ[:5]}')


def analysis_phase(torch, fails: list) -> None:
    """Phase 16: ``repro_torch.analysis.run_all(device='cuda')``; every
    failed finding is a failure of the script."""
    from repro_torch import analysis
    t0 = time.perf_counter()
    rep = analysis.run_all(device='cuda')
    torch.cuda.synchronize()
    for rule in sorted(rep.rules()):
        ok, na, failed = rep.counts(rule)
        print(f'analysis {rule}: {ok} ok, {na} not applicable, '
              f'{failed} failed')
    cells = {f.subject for f in rep.by_rule('T001')}
    print(f'analysis: {rep.summary()}; {len(cells)} cells on the card in '
          f'{time.perf_counter() - t0:.1f} s')
    for f in rep.failures:
        fails.append(f'analysis: {f}')
        print(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tier-kernels', action='store_true',
                    help='run only the build and the lag tier kernel phase')
    ap.add_argument('--rows-kernels', action='store_true',
                    help='run only the build and the rows kernel phases')
    ap.add_argument('--sparse-runs', action='store_true',
                    help='run only the build and the sparse, sparse-sweep '
                         'and tier phases')
    ap.add_argument('--train', action='store_true',
                    help='run only the build and the train phase')
    ap.add_argument('--checkpoint', action='store_true',
                    help='run only the build and the checkpoint phase')
    ap.add_argument('--analysis', action='store_true',
                    help='run only the build and the analysis phase')
    ap.add_argument('--src', type=pathlib.Path, default=None,
                    help='the src/ directory whose repro_torch to load')
    opts = ap.parse_args(argv)
    src = (opts.src or pathlib.Path(__file__).resolve().parent / 'src')
    if not (src / 'repro_torch').is_dir():
        print(f'chip_smoke: no repro_torch under {src}; run it from a '
              f'checkout of the repository', file=sys.stderr)
        return 2
    sys.path.insert(0, str(src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this check '
              'needs an NVIDIA GPU', file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(_card_line())
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}')

    from repro_torch.data.tasks import _cnn_init
    from repro_torch.kernels import backend, ops
    _, build_s = backend.load_library(verbose=True)
    print(f'build: {build_s:.1f} s')

    clock = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        print(f'phase {phase}: {now - clock[0]:.1f} s')
        clock[0] = now

    fails = []
    n = ops.wire_spec(_cnn_init(torch.Generator().manual_seed(0))).n_padded
    if opts.tier_kernels or opts.rows_kernels or opts.sparse_runs:
        print(f'repro_torch from {src.resolve()}')
        if opts.tier_kernels:
            tier_kernel_phase(torch, n, fails)
        if opts.rows_kernels:
            rows_kernel_phase(torch, n, fails)
            rows_fleet_kernel_phase(torch, n, fails)
            lap('rows kernels')
        if opts.sparse_runs:
            spec, task = cnn_setup(torch)
            sparse_phase(torch, spec, task, fails)
            lap('sparse')
            sparse_sweep_phase(torch, spec, task, fails)
            lap('sparse sweeps')
            del task
            torch.cuda.empty_cache()
            tier_phase(torch, fails)
            lap('tier')
        for f in fails:
            print(f'FAIL {f}')
        return 1 if fails else 0
    if opts.train or opts.checkpoint or opts.analysis:
        if opts.analysis:
            analysis_phase(torch, fails)
            lap('analysis')
        if opts.train:
            train_phase(torch, fails, new_readings())
            lap('train')
        if opts.checkpoint:
            checkpoint_phase(torch, fails)
            lap('checkpoint')
        for f in fails:
            print(f'FAIL {f}')
        return 1 if fails else 0
    runs = start_dryruns(src)
    try:
        return _all_phases(torch, kind, n, runs, lap, fails)
    finally:
        stop_dryruns(runs)


def _all_phases(torch, kind, n, runs, lap, fails) -> int:
    readings = new_readings()
    recs = (kernel_phase(torch, n, fails) + leaf_kernel_phase(torch, fails)
            + fleet_kernel_phase(torch, n, fails)
            + merge_kernel_phase(torch, n, fails)
            + rows_kernel_phase(torch, n, fails)
            + rows_fleet_kernel_phase(torch, n, fails)
            + tier_kernel_phase(torch, n, fails))
    torch.cuda.empty_cache()
    lap('kernels')
    analysis_phase(torch, fails)
    lap('analysis')
    spec, task = cnn_setup(torch)
    launches = main_path_phase(torch, spec, task, fails)
    lap('main')
    launches.update(quantize_uploads_phase(torch, spec, task, fails))
    lap('quantize_uploads')
    launches.update(fleet_path_phase(torch, spec, task, fails))
    lap('fleet')
    launches.update(baselines_phase(torch, spec, task, fails))
    lap('baselines')
    launches.update(weighted_phase(torch, spec, task, fails))
    lap('weighted')
    launches.update(sparse_phase(torch, spec, task, fails))
    lap('sparse')
    launches.update(sparse_sweep_phase(torch, spec, task, fails))
    lap('sparse sweeps')
    del task
    torch.cuda.empty_cache()
    launches.update(tier_phase(torch, fails))
    lap('tier')
    attn = attention_kernel_phase(torch, fails)
    recs += attn
    torch.cuda.empty_cache()
    lap('attention kernel')
    launches.update(serve_phase(torch, attn[0]['ms'], fails, readings))
    lap('serve')
    launches.update(families_phase(torch, {r['name']: r['ms'] for r in attn},
                                   fails, readings))
    lap('families')
    torch.cuda.empty_cache()
    launches.update(train_phase(torch, fails, readings))
    lap('train')
    dryrun_phase(torch, runs, readings, fails)
    lap('dryrun')
    launches.update(checkpoint_phase(torch, fails))
    lap('checkpoint')
    for r in recs:
        r['launches'] = launches.get(r['name'], 0)
        del r['bytes'], r['flops'], r['dense_bytes']
    if fails:
        for f in fails:
            print(f'FAIL {f}')
        return 1
    print(json.dumps({'kernels': recs}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
