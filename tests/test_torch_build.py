"""ops/_build.py compiles each source to an object in a process of its own
and links the objects into one library, cached by a hash of the sources
and flags. The CUDA build takes the same path with nvcc, which only the
card's machine has, so it is checked here with g++ on two C++ sources."""
import ctypes
import os
import shutil

import pytest

from mcpt_tpu_torch.ops import _build

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")

SOURCES = {
    "a.cpp": 'extern "C" int twice(int x);\nextern "C" int twice_plus_one(int x) { return twice(x) + 1; }\n',
    "b.cpp": 'extern "C" int twice(int x) { return 2 * x; }\n',
}


def _write(tmp_path, sources):
    paths = []
    for name, text in sources.items():
        p = tmp_path / name
        p.write_text(text)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("broken", [False, True], ids=["links", "compiler_error_raises"])
def test_compile_links_objects_and_caches(tmp_path, monkeypatch, broken):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    srcs = _write(tmp_path, dict(SOURCES, **({"b.cpp": "int broken(\n"} if broken else {})))
    gxx = shutil.which("g++")
    info = {}
    if broken:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            _build._compile(gxx, _build.GXX_FLAGS, _build.GXX_LINK_FLAGS, srcs, srcs, "libt", info)
        assert os.listdir(tmp_path / "out") == []  # no objects or partial library left
        return
    lib = _build._compile(gxx, _build.GXX_FLAGS, _build.GXX_LINK_FLAGS, srcs, srcs, "libt", info)
    assert os.listdir(tmp_path / "out") == [os.path.basename(lib)]
    assert info["cmd"].count(" -c ") == 2 and info["cmd"].splitlines()[-1].split()[1] == "-shared"
    fn = ctypes.CDLL(lib).twice_plus_one
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    assert fn(20) == 41
    again = {}
    assert _build._compile(gxx, _build.GXX_FLAGS, _build.GXX_LINK_FLAGS, srcs, srcs, "libt", again) == lib
    assert again == {}  # cached: nothing compiled
