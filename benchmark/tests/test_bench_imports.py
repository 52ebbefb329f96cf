"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the system under test.

Names are compared by their top-level part, whole: ``kevlar_tpu_torch``
begins with ``kevlar_tpu`` and is not the JAX package.
"""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
JAX = {'jax', 'jaxlib', 'flax', 'kevlar_tpu'}
SYSTEM = {'kevlar_tpu_torch'}


def modules():
    for folder, _, files in os.walk(BENCH):
        for name in sorted(files):
            if name.endswith('.py'):
                yield os.path.join(folder, name)


def top_level_imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
        elif isinstance(node, ast.Call) and \
                getattr(node.func, 'attr', None) == 'import_module' and \
                node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split('.')[0])
    return names


@pytest.mark.parametrize('path', list(modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    'path', [p for p in modules()
             if os.path.relpath(p, BENCH).startswith('reference' + os.sep)],
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_is_plain(path):
    assert not top_level_imports(path) & (JAX | SYSTEM)


def test_names_are_whole():
    """The check would catch the JAX package and let the port through."""
    src = 'import kevlar_tpu_torch.sketch\nfrom kevlar_tpu.ops import x\n'
    tree = ast.parse(src)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found.update(a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            found.add(node.module.split('.')[0])
    assert found & JAX == {'kevlar_tpu'}
    assert 'kevlar_tpu_torch' not in JAX


def test_run_refuses_jax_package(monkeypatch):
    """The entry's look at ``sys.modules`` after the window names what it
    finds, by whole top-level names."""
    import sys
    sys.path.insert(0, os.path.dirname(BENCH))
    from benchmark import run
    monkeypatch.setitem(sys.modules, 'kevlar_tpu.fake', object())
    assert 'kevlar_tpu' in run.forbidden_modules()
    monkeypatch.delitem(sys.modules, 'kevlar_tpu.fake')
    monkeypatch.setitem(sys.modules, 'kevlar_tpu_torch_extra', object())
    assert 'kevlar_tpu' not in run.forbidden_modules()
