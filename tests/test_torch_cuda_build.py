"""autodist_tpu_torch.utils.cuda_build on the CPU: what names a built
library. Nothing here runs nvcc; the builds themselves run on a card
(``chip_smoke.py`` phase 1)."""
import os
import shutil

from autodist_tpu_torch.utils import cuda_build


def test_library_path_changes_with_any_header(tmp_path):
    """The library's name hashes its source and every ``csrc/*.cuh``, so
    editing a header the kernels include cannot reuse a stale build."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    headers = sorted(p for p in os.listdir(csrc) if p.endswith(".cuh"))
    assert headers, "the kernels share their mma helpers in a header"
    before = {n: cuda_build.library_path(n, str(csrc))
              for n in cuda_build.KERNELS}
    # the copy names the same libraries as the package's own sources
    assert before == {n: cuda_build.library_path(n)
                      for n in cuda_build.KERNELS}
    with open(csrc / headers[0], "ab") as f:
        f.write(b"\n// edited\n")
    after = {n: cuda_build.library_path(n, str(csrc))
             for n in cuda_build.KERNELS}
    assert all(after[n] != before[n] for n in cuda_build.KERNELS)
    with open(csrc / "flash_fwd.cu", "ab") as f:
        f.write(b"\n")
    assert cuda_build.library_path("flash_fwd", str(csrc)) != \
        after["flash_fwd"]
    assert cuda_build.library_path("flash_bwd", str(csrc)) == \
        after["flash_bwd"]


def test_every_kernel_source_is_listed():
    """``KERNELS`` names every ``.cu`` source of ``csrc/`` (each builds
    into its own library, all in one parallel build)."""
    sources = sorted(p[:-3] for p in os.listdir(cuda_build.CSRC_DIR)
                     if p.endswith(".cu"))
    assert sorted(cuda_build.KERNELS) == sources
