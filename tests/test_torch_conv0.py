"""The port's fused conv0 (K4's plain version, ``ops/kernels/conv0_fused.py``)
and ``MVSNet(fused_conv0=True)`` against the JAX package's fused conv0 kernel
(run in interpret mode, as the JAX package's own tests run it) and its
``pallas_conv0`` model, with the same weights."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from scene_3dreconstruction_mvsnet_tpu.interop import import_torch_state_dict
from scene_3dreconstruction_mvsnet_tpu.models import MVSNet as JaxMVSNet
from scene_3dreconstruction_mvsnet_tpu.ops.flat_conv import unpack_flat
from scene_3dreconstruction_mvsnet_tpu.ops.pallas.conv0_fused import conv0_bn_relu_fused
from scene_3dreconstruction_mvsnet_tpu_torch.interop import load_jax_variables
from scene_3dreconstruction_mvsnet_tpu_torch.models import MVSNet
from scene_3dreconstruction_mvsnet_tpu_torch.models.blocks import BatchNorm3d
from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels.conv0_fused import conv0_bn_relu, fold_bn
from tests.test_models_parity import _rand_state_dict

torch.set_num_threads(1)


@pytest.mark.parametrize("B,D,H,W", [(1, 5, 8, 32), (2, 4, 6, 35)])
def test_fused_conv0_matches_jax_kernel(B, D, H, W):
    """The plain version (f32 conv of bf16-rounded inputs, folded BN, ReLU,
    one bf16 rounding) against the JAX kernel, which rounds the conv to bf16
    and applies the folded BN in bf16: atol 3e-2 x max|y|, the bound JAX
    holds its kernel to against its XLA path (tests/test_conv0_fused.py)."""
    rng = np.random.RandomState(0)
    x = rng.rand(B, D, H, W, 32).astype(np.float32)
    k = (rng.rand(3, 3, 3, 32, 8) - 0.5).astype(np.float32)  # DHWIO
    scale, bias = rng.uniform(0.5, 1.5, 8).astype(np.float32), rng.uniform(-0.5, 0.5, 8).astype(np.float32)
    mean, var = rng.uniform(-1, 1, 8).astype(np.float32), rng.uniform(0.2, 2.0, 8).astype(np.float32)

    got = conv0_bn_relu_fused(*(jnp.asarray(a) for a in (x, k, scale, bias, mean, var)), interpret=True)
    want = np.asarray(unpack_flat(got.reshape(B * D, H, got.shape[-2], 128).astype(jnp.float32), 8, W))
    want = want.reshape(B, D, H, W, 8)

    bn = BatchNorm3d(8, eps=1e-5).eval()
    weight = torch.from_numpy(k).permute(4, 3, 0, 1, 2)  # DHWIO -> [O, I, kd, kh, kw]
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias), ("running_mean", mean), ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
        ours = conv0_bn_relu(torch.from_numpy(x).to(torch.bfloat16), weight, *fold_bn(bn))
    assert ours.dtype == torch.bfloat16 and ours.shape == (B, 8, D, H, W)
    ours = ours.float().permute(0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(ours, want, atol=3e-2 * np.abs(want).max())


def _scene():
    """tests/test_conv0_fused.py::test_full_mvsnet_pallas_conv0_matches_flat's
    scene: 3 translated views of 64x64, 8 planes over 40-60."""
    rng = np.random.RandomState(3)
    imgs = rng.rand(1, 3, 64, 64, 3).astype(np.float32)
    projs = np.broadcast_to(np.eye(4, dtype=np.float32), (1, 3, 4, 4)).copy()
    projs[:, 1, 0, 3], projs[:, 2, 0, 3] = -1.0, 1.0
    return imgs, projs, np.linspace(40.0, 60.0, 8, dtype=np.float32)[None]


def test_mvsnet_fused_conv0_matches_jax_pallas_conv0():
    """The bf16 eval forward with the fused conv0 against the JAX package's
    bf16 flat CostRegNet with its fused conv0, the same weights through
    ``from_jax``: depth within 2e-2 x the depth range, confidence within
    5e-2 (the bounds of tests/test_conv0_fused.py). The weights are flax's
    initialisation, as there, with non-trivial running statistics: its
    logits are smooth enough that bf16 rounding moves the depth
    expectation a little (larger random weights make the softmax one-hot, and
    any rounding then jumps the depth by a whole plane)."""
    imgs, projs, dv = _scene()
    jmodel = JaxMVSNet(refine=False, dtype=jnp.bfloat16, flat_costreg=True, pallas_conv0=True)
    variables = JaxMVSNet(refine=False, dtype=jnp.bfloat16, flat_costreg=True).init(
        jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(projs), jnp.asarray(dv))
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda a: a + 0.1 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape) / a.size, variables["batch_stats"])}
    ref = jmodel.apply(variables, jnp.asarray(imgs), jnp.asarray(projs), jnp.asarray(dv), train=False)
    variables = jax.tree.map(np.asarray, variables)
    port = load_jax_variables(MVSNet(dtype=torch.bfloat16, fused_conv0=True), variables).eval()
    with torch.inference_mode():
        out = port(torch.from_numpy(imgs), torch.from_numpy(projs), torch.from_numpy(dv))
    depth_err = np.abs(out["depth"].numpy() - np.asarray(ref["depth"], np.float32)).max()
    assert depth_err < 2e-2 * (dv.max() - dv.min()), depth_err
    np.testing.assert_allclose(out["photometric_confidence"].numpy(),
                               np.asarray(ref["photometric_confidence"], np.float32), atol=5e-2)


def test_fused_conv0_leaves_training_unchanged():
    """In train mode ``fused_conv0`` takes the module conv0: the outputs and
    the BatchNorm running statistics are identical with and without it."""
    imgs, projs, dv = _scene()
    variables = import_torch_state_dict(_rand_state_dict(np.random.RandomState(1)))
    models = [load_jax_variables(MVSNet(dtype=torch.bfloat16, fused_conv0=f), variables).train() for f in (False, True)]
    outs = [m(torch.from_numpy(imgs), torch.from_numpy(projs), torch.from_numpy(dv)) for m in models]
    for k in ("depth", "photometric_confidence"):
        torch.testing.assert_close(outs[1][k], outs[0][k], rtol=0, atol=0)
    for (name, a), (_, b) in zip(models[0].state_dict().items(), models[1].state_dict().items()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("B,D,H,W", [(1, 192, 216, 288), (1, 3, 9, 37), (2, 1, 8, 33), (1, 2, 10, 40),
                                     (2, 13, 16, 64)])
def test_conv0_launch_geometry(B, D, H, W):
    """K4's launch covers every output voxel and plane with no empty chunk,
    fits two blocks' shared memory in an SM, and at the headline gives the
    132 SMs several blocks each."""
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import conv0_fused as k4

    g = k4.launch_geometry(B, D, H, W)
    assert g["tiles_y"] * k4.TILE_H >= H > (g["tiles_y"] - 1) * k4.TILE_H
    assert g["tiles_x"] * k4.TILE_W >= W > (g["tiles_x"] - 1) * k4.TILE_W
    assert g["grid"][0] == B * g["tiles_y"] * g["tiles_x"]
    assert g["d_chunk"] * g["grid"][1] >= D > (g["grid"][1] - 1) * g["d_chunk"]
    assert g["d_chunk"] >= min(D, k4.MIN_CHUNK)
    assert g["threads"] == 256 and g["smem_bytes"] == 83200  # the ring, the weights, the transpose
    assert k4.BLOCKS_PER_SM * (g["smem_bytes"] + 1024) <= 228 * 1024  # 1 KB of each block is the system's
    if (B, D, H, W) == (1, 192, 216, 288):
        assert g["grid"] == (243, 9) and g["d_chunk"] == 22
        assert g["grid"][0] * g["grid"][1] >= 8 * 132


def test_conv0_weight_fragments_emulate_the_conv():
    """The implicit GEMM the kernel runs, emulated on the CPU with the
    wrapper's weight fragments read back as the mma reads them (lane l holds
    B[k, n] for n = l // 4 and k = 2 (l % 4) + (0, 1, 8, 9)): for each tap
    (kd, kh, kw) and half of the input channels, the volume shifted by the tap
    times that B. Equal to the plain conv of the same bf16 values (f32 sums in
    another order)."""
    from scene_3dreconstruction_mvsnet_tpu_torch.ops.kernels import conv0_fused as k4

    rng = np.random.RandomState(6)
    B, D, H, W = 1, 3, 5, 7
    x = torch.from_numpy(rng.rand(B, D, H, W, 32).astype(np.float32)).to(torch.bfloat16).float()
    weight = torch.from_numpy((rng.rand(8, 32, 3, 3, 3) - 0.5).astype(np.float32))
    frags = k4.mma_weight_fragments(weight).float()  # [27, 2, 32, 4]
    b_mat = torch.zeros(27, 2, 16, 8)
    for lane in range(32):
        n, t = lane // 4, 2 * (lane % 4)
        for j, k in enumerate((t, t + 1, t + 8, t + 9)):
            b_mat[:, :, k, n] = frags[:, :, lane, j]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    got = torch.zeros(B, D, H, W, 8, dtype=torch.float64)
    for tap in range(27):
        kd, kh, kw = tap // 9, (tap // 3) % 3, tap % 3
        for h in range(2):
            a = xp[:, kd:kd + D, kh:kh + H, kw:kw + W, 16 * h:16 * h + 16]
            got += (a.double() @ b_mat[tap, h].double())
    with torch.no_grad():
        want = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3).double(),
                                          weight.to(torch.bfloat16).double(), padding=1)
    torch.testing.assert_close(got.permute(0, 4, 1, 2, 3), want, rtol=0, atol=1e-12)
