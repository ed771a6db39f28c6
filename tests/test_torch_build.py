"""The port's nvcc build key: a library is rebuilt when its sources, any header under csrc/ or its flags change."""

from improving_yolov8_cbam_swinblock_tpu_torch.ops import cuda_build


def test_library_path_follows_sources_headers_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "mma.cuh"\n')
    (tmp_path / "mma.cuh").write_text("// v1\n")
    first = cuda_build.library_path("k", ("k.cu",))
    assert first == cuda_build.library_path("k", ("k.cu",))
    assert first.parent.parent == cuda_build.BUILD_DIR and first.name == "libk.so"
    (tmp_path / "mma.cuh").write_text("// v2\n")  # only the header changes
    second = cuda_build.library_path("k", ("k.cu",))
    assert second != first
    (tmp_path / "extra.h").write_text("// another header\n")
    third = cuda_build.library_path("k", ("k.cu",))
    assert third != second
    (tmp_path / "k.cu").write_text('#include "mma.cuh"\n// edited\n')
    assert cuda_build.library_path("k", ("k.cu",)) != third
    assert cuda_build.library_path("k", ("k.cu",), ("-DX",)) != cuda_build.library_path("k", ("k.cu",))
