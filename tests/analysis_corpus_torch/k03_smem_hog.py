"""K3 corpus: a launch asking more shared memory than one block can have.

The float32 flash route at its requested tile (``bq = bk = 128``) and
D = 256 stages the scaled query tile, the padded K and V stages and the
warps' probabilities: 411,648 bytes, over sm_90's 232,448 (227 KB) per
block, and the launch fails (``cudaFuncSetAttribute`` refuses it). The
wrapper's ``tile_sizes`` shrinks the tile first; ``GOOD`` is what it
launches. Do not fix: tests/test_torch_analysis.py asserts ``BAD`` fires
and ``GOOD`` fits.
"""
from repro_torch.analysis.kernel_audit import KernelSpec
from repro_torch.kernels.flash_attention import ops as fa

BAD = KernelSpec("flash float32, D = 256, the unshrunk 128 x 128 tile",
             "flash_attention", "flash_kernel<256>", 512,
             fa.smem_bytes(128, 128, 256))
_bq, _bk = fa.tile_sizes(128, 128, 8192, 8192, 256)
GOOD = KernelSpec("flash float32, D = 256, the tile tile_sizes picks",
              "flash_attention", "flash_kernel<256>", _bq // 8 * 32,
              fa.smem_bytes(_bq, _bk, 256))
