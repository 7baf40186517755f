"""What the harness loads: no JAX, no JAX package (top-level names compared
whole, so the port's name, which begins with the JAX package's, passes),
and a reference that imports nothing of the program."""

import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.tiny import REPO


@pytest.mark.parametrize("name,banned", [("l4p_tpu_torch.ops", False), ("l4p_tpu", True), ("l4p_tpu.models", True),
                                         ("jax._src", True), ("jaxlib", True), ("flax.linen", True),
                                         ("jaxtyping", False), ("l4p_tpu_x", False)])
def test_top_level_names_compared_whole(monkeypatch, name, banned):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in run.banned_modules()) == banned


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys; print(' '.join(sorted({m.split('.')[0] "
                                                        "for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, check=True, timeout=300).stdout
    return set(out.split())


def test_the_harness_loads_no_jax():
    mods = loaded_after("import portbench.run, portbench.calibrate, portbench.drivers.offline, l4p_tpu_torch, "
                        "l4p_tpu_torch.inference, l4p_tpu_torch.models.track, l4p_tpu_torch.models.sam")
    assert not mods & set(run.BANNED)


def test_the_reference_imports_nothing_of_the_program():
    mods = loaded_after("import portbench.reference.l4p.inference, portbench.reference.l4p.ops.lowp")
    assert not mods & {"l4p_tpu_torch", *run.BANNED}


def test_reference_sources_name_no_program_module():
    for path in (REPO / "portbench" / "reference").rglob("*.py"):
        text = path.read_text()
        assert "l4p_tpu_torch" not in text.replace("l4p_tpu_torch/", ""), path
        assert "import jax" not in text and "from jax" not in text, path
