"""The CUDA build's cache key: a kernel library is rebuilt when its source or
any ``csrc`` header it includes changes. Runs no compiler."""

import torch

from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import CSRC_DIR, source_digest

torch.set_num_threads(1)


def test_digest_covers_included_headers(tmp_path):
    (tmp_path / "kernel.cu").write_text('#include <cuda_runtime.h>\n#include "shared.cuh"\nint k() { return f(); }\n')
    (tmp_path / "shared.cuh").write_text('#include "leaf.cuh"\ninline int f() { return 1; }\n')
    (tmp_path / "leaf.cuh").write_text("// leaf v1\n")
    first = source_digest(tmp_path / "kernel.cu")
    assert source_digest(tmp_path / "kernel.cu") == first
    (tmp_path / "shared.cuh").write_text('#include "leaf.cuh"\ninline int f() { return 2; }\n')
    second = source_digest(tmp_path / "kernel.cu")
    (tmp_path / "leaf.cuh").write_text("// leaf v2\n")  # reached through shared.cuh
    third = source_digest(tmp_path / "kernel.cu")
    assert len({first, second, third}) == 3


def test_both_sweep_kernels_include_the_shared_coordinates():
    """K1 and K3 take their coordinates from one header, so an edit there
    rebuilds both."""
    for name in ("sweep_variance", "warp_grad"):
        assert '#include "sweep_coords.cuh"' in (CSRC_DIR / f"{name}.cu").read_text()
