"""Build the native IO extension in-place (g++, CPython API; no pybind11).

Usage:  python native/build.py
Places _sphinxsys_fastio.so next to the sphinxsys_jax package.
"""

import os
import subprocess
import sysconfig

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def build():
    include = sysconfig.get_paths()["include"]
    ext_suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(REPO, "_sphinxsys_fastio" + ext_suffix)
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        f"-I{include}",
        os.path.join(HERE, "fastio.cpp"),
        "-o", out,
    ]
    subprocess.check_call(cmd)
    print("built", out)
    return out


if __name__ == "__main__":
    build()
