"""The port's tests build fermi_tpu's native library whole
(tests/native_lock.py): while the build runs, the library's path holds
nothing or the finished file, never the linker's growing output, which a
concurrent loader fails on ("file too short") or maps half written."""

import ctypes
import os
import threading

from native_lock import build_whole, load_fermi_tpu_native

MAKEFILE = """CXX ?= g++
BUILD := build
LIB := $(BUILD)/libfake.so

all: $(LIB)

$(BUILD):
\tmkdir -p $(BUILD)

$(LIB): fake.cpp | $(BUILD)
\t$(CXX) -O2 -fPIC -shared -o $@ fake.cpp
"""


def test_library_path_holds_nothing_or_the_whole_file(tmp_path):
    (tmp_path / "Makefile").write_text(MAKEFILE)
    (tmp_path / "fake.cpp").write_text(
        'extern "C" int fake_sum(int n) { int s = 0;'
        ' for (int i = 0; i < n; i++) s += i; return s; }\n'
        + "".join(f'extern "C" int fake_{i}(int x) {{ return x * {i}; }}\n'
                  for i in range(2000)))
    lib = tmp_path / "build" / "libfake.so"
    seen, done = set(), threading.Event()

    def watch():
        while not done.is_set():
            try:
                seen.add(os.path.getsize(lib))
            except FileNotFoundError:
                pass

    watcher = threading.Thread(target=watch)
    watcher.start()
    try:
        build_whole(str(tmp_path), "libfake.so")
    finally:
        done.set()
        watcher.join()
    assert seen <= {os.path.getsize(lib)}
    assert ctypes.CDLL(str(lib)).fake_sum(5) == 10
    assert os.listdir(tmp_path / "build") == ["libfake.so"]


def test_fermi_tpu_native_loads():
    lib = load_fermi_tpu_native()
    assert lib.fsa_bwt is not None
    assert load_fermi_tpu_native() is lib
