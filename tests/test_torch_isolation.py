"""The port stands alone: nothing in ``src/repro_torch`` or
``chip_smoke.py`` imports JAX or the JAX package, statically or at run
time."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / 'src' / 'repro_torch').rglob('*.py')) + \
    [ROOT / 'chip_smoke.py']
FORBIDDEN = ('jax', 'repro')
#: modules that hold bf16 without numpy's bf16 type (the card's host has no
#: ``ml_dtypes``): the checkpoint layer and the closed-form metrics
NO_ML_DTYPES = [ROOT / 'src' / 'repro_torch' / p for p in (
    'checkpoint/__init__.py', 'core/metrics.py', 'core/bias.py',
    'launch/serve.py', 'launch/train.py')]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0], node.lineno


@pytest.mark.parametrize('path', FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f'{path.relative_to(ROOT)} imports {bad}'


@pytest.mark.parametrize('path', NO_ML_DTYPES,
                         ids=[str(p.relative_to(ROOT)) for p in NO_ML_DTYPES])
def test_no_ml_dtypes_imports(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name in FORBIDDEN + ('ml_dtypes',)]
    assert not bad, f'{path.relative_to(ROOT)} imports {bad}'


def test_import_pulls_in_neither_jax_nor_the_reference():
    code = (
        'import sys\n'
        'import repro_torch, repro_torch.api, repro_torch.data.tasks\n'
        'import repro_torch.models.model, repro_torch.launch.serve\n'
        'import repro_torch.launch.train, repro_torch.checkpoint\n'
        'import repro_torch.core.metrics, repro_torch.core.bias\n'
        'bad = sorted(m for m in sys.modules if m == "jax" '
        'or m.startswith("jax.") or m.startswith("jaxlib") '
        'or m.startswith("ml_dtypes") '
        'or m == "repro" or m.startswith("repro."))\n'
        'print(",".join(bad))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / 'src')))
    assert out.stdout.strip() == '', out.stdout
