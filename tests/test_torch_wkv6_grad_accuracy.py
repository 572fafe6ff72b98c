"""``tools/wkv6_grad_accuracy.py`` on the CPU at rwkv6-7b's reduced
config: both paths run the plain recurrence here, so the pair and the
inputs' distance are 0, and each path's gradients lie within f32
rounding of the float64 recurrence on its own inputs."""
import importlib.util
import json
from pathlib import Path

TOOL = Path(__file__).resolve().parent.parent / "tools" / \
    "wkv6_grad_accuracy.py"


def test_reduced_run_records_every_layer_and_gradient(capsys):
    spec = importlib.util.spec_from_file_location("wkv6_grad_accuracy", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--device", "cpu", "--reduced", "--layers", "2",
                      "--tokens", "40", "--seeds", "0", "1"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{"seed"')]
    assert [(r["seed"], r["layer"]) for r in rows] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in rows:
        for n in ("u", "w", "r", "k", "v"):
            assert r[n]["pair"] == 0.0 and r[n]["inputs"] == 0.0, (r, n)
            assert 0.0 < r[n]["own_kernels"] < 1e-5, (r, n)
            assert r[n]["own_plain"] == r[n]["own_kernels"], (r, n)
