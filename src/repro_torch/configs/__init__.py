"""Architecture registry: ``get_config('<arch-id>')`` for the 10 assigned
architectures, plus input-shape definitions and paper-task FL settings."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    'h2o-danube-3-4b',
    'minitron-4b',
    'nemotron-4-340b',
    'zamba2-1.2b',
    'internvl2-26b',
    'llama4-maverick-400b-a17b',
    'llama4-scout-17b-a16e',
    'qwen3-1.7b',
    'mamba2-130m',
    'whisper-medium',
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace('-', '_').replace('.', '_')


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f'unknown arch {arch_id!r}; known: {ARCH_IDS}')
    mod = importlib.import_module(f'repro_torch.configs.{_module_name(arch_id)}')
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}


# ---------------------------------------------------------------------------
# Assigned input shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str   # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    'train_4k': InputShape('train_4k', 4_096, 256, 'train'),
    'prefill_32k': InputShape('prefill_32k', 32_768, 32, 'prefill'),
    'decode_32k': InputShape('decode_32k', 32_768, 128, 'decode'),
    'long_500k': InputShape('long_500k', 524_288, 1, 'decode'),
}

# long_500k requires decode memory sub-linear in (or bounded against) context:
# SSM state (mamba2), hybrid SSM + bounded attn invocations (zamba2), or
# native sliding-window KV (h2o-danube).  Pure full-attention archs skip it
# (DESIGN.md §4).
LONG_CONTEXT_ARCHS = {'mamba2-130m', 'zamba2-1.2b', 'h2o-danube-3-4b'}


def shape_supported(arch_id: str, shape_name: str) -> bool:
    if shape_name == 'long_500k':
        return arch_id in LONG_CONTEXT_ARCHS
    return True


# ---------------------------------------------------------------------------
# Paper FL experiment settings (Table II)
# ---------------------------------------------------------------------------

PAPER_TASKS = {
    'task1_regression': dict(m=5, dataset_size=506, rounds=100, epochs=3,
                             batch_size=5, lr=1e-4, t_lim=830.0, features=13),
    'task2_cnn': dict(m=100, dataset_size=70_000, rounds=50, epochs=5,
                      batch_size=40, lr=1e-3, t_lim=5600.0, features=(28, 28)),
    'task3_svm': dict(m=500, dataset_size=186_480, rounds=100, epochs=5,
                      batch_size=100, lr=1e-2, t_lim=1620.0, features=35),
}
