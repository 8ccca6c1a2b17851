"""ops.build's kernel builds, with a stand-in for nvcc (no CUDA toolkit is
needed): a library that ``build_all`` is compiling in the background is
waited for, not compiled a second time, by ``build`` in another thread."""

import sys
import threading

import pytest

pytest.importorskip("torch")

from raymarching_tpu_torch.ops import build  # noqa: E402

FAKE_NVCC = """\
import sys, time
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(args[-1] + "\\n")
time.sleep(0.5)
open(args[args.index("-o") + 1], "w").write("library")
print("ptxas info    : Used 32 registers")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in compiler that logs each source it is given, takes half a
    second and writes the output file; builds go to tmp_path."""
    log = tmp_path / "compiled.txt"
    script = tmp_path / "nvcc.py"
    script.write_text(FAKE_NVCC.format(log=str(log)))
    wrapper = tmp_path / "nvcc"
    wrapper.write_text(f"#!/bin/sh\nexec {sys.executable} {script} \"$@\"\n")
    wrapper.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(wrapper))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    return log


def test_build_waits_for_the_background_build(fake_nvcc):
    """build_all in a background thread and build of the same kernels in
    this one: one compile a kernel, and both get the same library."""
    names = ("march_kernel", "surface_kernel")
    out = {}
    bg = threading.Thread(target=lambda: out.update(
        all=build.build_all(names)))
    bg.start()
    mine = [build.build(n) for n in reversed(names)][::-1]
    bg.join()
    assert [p for p, _ in out["all"]] == mine
    assert all(p.exists() and p.with_suffix(".log").exists() for p in mine)
    compiled = fake_nvcc.read_text().split()
    assert sorted(compiled) == sorted(str(build.source(n)) for n in names)
    # an existing library is reused, not compiled again
    assert build.build(names[0]) == mine[0]
    assert len(fake_nvcc.read_text().split()) == len(names)
