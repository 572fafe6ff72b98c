"""The port imports nothing of JAX or of the JAX package: every module
under ``src/repro_torch/`` (the LM stack and everything before it),
``chip_smoke.py`` and ``tools/*.py``, read with ``ast`` — absolute and
relative imports, and module names handed to ``importlib.import_module``
or ``__import__`` — and a run of the LM serving path in a fresh process
that must leave ``jax`` and ``repro`` unloaded."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
LM_MODULES = ("configs/base.py", "configs/__init__.py",
              "models/layers.py", "models/attention.py", "models/moe.py",
              "models/mamba.py", "models/rwkv.py", "models/transformer.py",
              "train/serve_step.py", "data/synthetic.py", "launch/serve.py",
              "convert.py")


def _package(path: Path) -> str:
    if path.is_relative_to(ROOT / "src"):
        return ".".join(path.relative_to(ROOT / "src").parent.parts)
    return ""


def _imported(path: Path, package: str):
    """(line, module) for every module the file names in an import;
    ``package`` is the file's own, for relative imports."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:                        # relative to the package
                parts = package.split(".")
                base = parts[:len(parts) - node.level + 1]
                yield node.lineno, ".".join(base + [node.module or ""])
            else:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


def test_port_and_chip_smoke_import_nothing_of_jax():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    assert {PORT / m for m in LM_MODULES} <= set(files)
    assert ROOT / "tools" / "wkv6_grad_accuracy.py" in files
    bad = [f"{p.relative_to(ROOT)}:{line}: {mod}" for p in files
           for line, mod in _imported(p, _package(p))
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_the_guard_sees_every_kind_of_import(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text("import os, jax.numpy\nfrom repro.core import fit\n"
                   "from . import sibling\nfrom ..up import x\n"
                   "importlib.import_module('jaxlib')\n")
    names = [m for _, m in _imported(mod, "pkg.sub")]
    assert names == ["os", "jax.numpy", "repro.core", "pkg.sub.", "pkg.up",
                     "jaxlib"]


def test_lm_path_leaves_jax_unloaded():
    code = (
        "import sys, torch\n"
        "from repro_torch.configs import get_arch\n"
        "from repro_torch.models.transformer import init_params\n"
        "from repro_torch.train.serve_step import greedy_generate\n"
        "from repro_torch.data.synthetic import SyntheticPipeline\n"
        "import repro_torch.launch.serve, repro_torch.convert\n"
        "cfg = get_arch('jamba-1.5-large-398b').reduced()\n"
        "p = init_params(cfg, device='cpu')\n"
        "b = SyntheticPipeline(cfg, 1, 8, device='cpu').next_batch()\n"
        "greedy_generate(cfg, p, b['tokens'], 2)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


TRAIN_MODULES = ("optim/__init__.py", "optim/schedules.py",
                 "optim/adamw.py", "optim/adafactor.py", "utils/tree.py",
                 "train/train_step.py", "launch/train.py",
                 "runtime/fault_tolerance.py")


def test_train_modules_are_among_the_walked_files():
    files = set(PORT.rglob("*.py"))
    assert {PORT / m for m in TRAIN_MODULES} <= files
    bad = [f"{m}:{line}: {mod}" for m in TRAIN_MODULES
           for line, mod in _imported(PORT / m, _package(PORT / m))
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_train_path_leaves_jax_unloaded(tmp_path):
    code = (
        "import sys, torch\n"
        "import repro_torch.optim.adamw, repro_torch.optim.adafactor\n"
        "from repro_torch.launch import train\n"
        f"train.main(['--arch', 'arctic-480b', '--reduced', '--steps', '2',"
        f" '--batch', '2', '--seq-len', '8', '--device', 'cpu',"
        f" '--ckpt-dir', {str(tmp_path)!r}])\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


SHARDED_MODULES = ("sharding/__init__.py", "sharding/specs.py",
                   "sharding/collectives.py", "sharding/state.py",
                   "launch/specs.py", "optim/compression.py",
                   "checkpoint/reshard.py", "checkpoint/manager.py",
                   "core/engine/stats.py", "launch/mesh.py")


def test_sharded_modules_are_among_the_walked_files():
    files = set(PORT.rglob("*.py"))
    assert {PORT / m for m in SHARDED_MODULES} <= files
    bad = [f"{m}:{line}: {mod}" for m in SHARDED_MODULES
           for line, mod in _imported(PORT / m, _package(PORT / m))
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_sharded_path_leaves_jax_unloaded(tmp_path):
    """Two gloo ranks of the sharded step (tp with fsdp, reduced mixtral:
    the expert-parallel MoE) from a fresh process that also imports the
    sharding, resharding and compression modules: no rank and not the
    parent loads JAX."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import torch_dist_ranks as R\n"
        "from repro_torch.launch import spawn_ranks\n"
        "import repro_torch.checkpoint.reshard, repro_torch.launch.specs\n"
        "import repro_torch.optim.compression\n"
        "def main():\n"
        "    case = dict(key='k', arch='mixtral-8x22b', mesh=[(1, 2),"
        " ('data', 'model')], layout='tp', fsdp=True, steps=1, batch=2,"
        " seq=8)\n"
        "    out = spawn_ranks(R.lm_dist_loaded, 2, args=(dict(device='cpu',"
        " seed=0, cases=[case]),), timeout_s=240,"
        f" dir={str(tmp_path)!r})\n"
        "    bad = sorted(m for m in sys.modules\n"
        "                 if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "    bad += [m for r in out for m in r['loaded']]\n"
        "    print(bad); sys.exit(1 if bad else 0)\n"
        "if __name__ == '__main__':\n"
        "    main()\n")
    script = tmp_path / "run.py"
    script.write_text(code)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
