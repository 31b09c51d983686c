"""Wheel build that compiles and bundles the native library.

Parity goal: the reference ships a pip-installable package that builds
its shared library during the wheel build (reference:
bindings/python/setup.py + CMake).  Here the native components (presolver
+ MPS reader, native/Makefile) are compiled with `make`
and the resulting libhprlp_native.so is packaged as
hprlp_tpu/_native/libhprlp_native.so, which hprlp_tpu.native checks
first at import time (source checkouts keep using native/lib/).
"""

import os
import shutil
import subprocess

from setuptools import setup
from setuptools.command.build_py import build_py

HERE = os.path.dirname(os.path.abspath(__file__))


class BuildWithNative(build_py):
    def run(self):
        native_dir = os.path.join(HERE, "native")
        lib = os.path.join(native_dir, "lib", "libhprlp_native.so")
        try:
            subprocess.run(["make", "-C", native_dir,
                            "lib/libhprlp_native.so"], check=True)
        except Exception as e:  # wheel still works; ctypes falls back
            print(f"warning: native build failed ({e}); the wheel will "
                  "build the library on first use instead")
        super().run()
        if os.path.exists(lib):
            dest_dir = os.path.join(self.build_lib, "hprlp_tpu", "_native")
            os.makedirs(dest_dir, exist_ok=True)
            shutil.copy2(lib, dest_dir)


setup(cmdclass={"build_py": BuildWithNative})
