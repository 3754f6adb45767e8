"""fermi_tpu's native library, built and loaded whole before a port test
runs.

`fermi_tpu.native.get_lib` builds the library at first use with `make`
straight into one fixed path, behind a thread lock only. A test process
that asks for it while another process's linker is still writing that
file finds it present, does not build, and fails to load it ("file too
short"), or maps a file that is still growing. Each port test file that
reaches fermi_tpu calls `load_fermi_tpu_native()` as it is imported; every
pytest-xdist worker imports every test file at collection, before any
test runs, so the library is whole before any test or its child process
asks for it. The port's workers take turns under a file lock, and the one
that builds does it in a directory of its own and renames the library into
place.
"""

import fcntl
import os
import shutil
import subprocess
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK_PATH = os.path.join(ROOT, "fermi_tpu_torch", "build",
                         "fermi_tpu_native.lock")


def build_whole(native_dir, lib_name="libfermi_native.so"):
    """Run `native_dir`'s Makefile with its build directory moved to a
    temporary one, then rename the library into `native_dir/build/`:
    that path holds a whole library or none."""
    build = os.path.join(native_dir, "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".whole-", dir=build)
    try:
        subprocess.run(["make", "-s", "-C", native_dir, f"BUILD={tmp}"],
                       check=True)
        os.replace(os.path.join(tmp, lib_name), os.path.join(build, lib_name))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_fermi_tpu_native():
    """fermi_tpu's native library in this process, built (once per tree)
    and loaded under `LOCK_PATH`."""
    from fermi_tpu import native

    os.makedirs(os.path.dirname(LOCK_PATH), exist_ok=True)
    with open(LOCK_PATH, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)  # released as the file closes
        if native._lib is None and native._sources_newer():
            build_whole(native._HERE)
        return native.get_lib()
