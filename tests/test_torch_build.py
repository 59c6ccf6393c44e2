"""The kernel build under concurrent first use, on the CPU.

Two serving lanes step from two executor threads, and each may be the
first to launch a kernel.  ``build.library`` must then compile the source
once and hand every thread the same loaded library.  ``nvcc`` is replaced
by a script that sleeps and writes its output file, and ``ctypes.CDLL`` by
a stub, so the test needs no CUDA toolkit.
"""
import stat
import sys
import threading

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

N_THREADS = 4

# appends one line to the log per compile, then writes the -o file slowly
# enough that every thread is inside library() while it runs
FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
time.sleep(0.3)
with open(out, "wb") as f:
    f.write(b"half")
    f.flush()
    time.sleep(0.05)
    f.write(b" written")
"""


def test_concurrent_first_use_compiles_once_and_shares_one_handle(
        tmp_path, monkeypatch):
    csrc, out_dir, log = tmp_path / "csrc", tmp_path / "_build", \
        tmp_path / "nvcc.log"
    csrc.mkdir()
    (csrc / "x.cu").write_text("// a kernel source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    loaded = []

    class FakeCDLL:
        def __init__(self, path):
            with open(path, "rb") as f:
                self.content = f.read()
            loaded.append(self)

    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out_dir)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build.ctypes, "CDLL", FakeCDLL)
    monkeypatch.setattr(build, "_libs", {})

    start = threading.Barrier(N_THREADS)
    handles, errors = [None] * N_THREADS, []

    def first_use(i):
        start.wait(timeout=10)
        try:
            handles[i] = build.library("x")
        except Exception as e:          # recorded, asserted below
            errors.append(e)

    threads = [threading.Thread(target=first_use, args=(i,))
               for i in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(log.read_text().splitlines()) == 1      # one compile
    assert len(loaded) == 1                              # one load
    assert all(h is loaded[0] for h in handles)          # one shared handle
    assert loaded[0].content == b"half written"
    assert [p.name for p in out_dir.iterdir()] == [
        build.library_path("x").name]                    # no stray temp file
    assert build.library("x") is loaded[0]


def test_build_names_its_temporary_file_by_process_and_thread(
        tmp_path, monkeypatch):
    """Two threads calling ``build`` directly write two temporary files."""
    csrc, log = tmp_path / "csrc", tmp_path / "nvcc.log"
    csrc.mkdir()
    (csrc / "x.cu").write_text("// a kernel source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    start = threading.Barrier(2)
    errors = []

    def run():
        start.wait(timeout=10)
        try:
            build.build(["x"])
        except Exception as e:          # recorded, asserted below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    temps = log.read_text().splitlines()
    assert len(temps) == 2 and len(set(temps)) == 2
    assert build.library_path("x").read_bytes() == b"half written"
