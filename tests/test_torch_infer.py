"""The port's sliding-window inference, metrics and ``run_inference``
held against ``mmr_tpu/infer`` and ``mmr_tpu/metrics`` (the cases of
``tests/test_infer.py``, plus JAX-vs-port on the same inputs)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mmr_tpu.infer import sliding_window as jsw
from mmr_tpu_torch.infer.evaluator import run_inference
from mmr_tpu_torch.infer.sliding_window import (
    _window_starts, gaussian_importance_map, make_sliding_window_fn,
    sliding_window_inference)
from mmr_tpu_torch.metrics import iou_score, segmentation_stats
from mmr_tpu_torch.ops.fused_conv import Pending


def _swi(x, pred, **kw):
    return sliding_window_inference(torch.from_numpy(x), pred, **kw).numpy()


def test_window_starts_grid():
    assert _window_starts(128, 64, 0.5) == [0, 32, 64]
    assert _window_starts(100, 64, 0.5) == [0, 32, 36]
    assert _window_starts(64, 64, 0.5) == [0]
    assert _window_starts(50, 64, 0.5) == [0]
    # the full-HD serving grid: 4 x 5 windows of 512 x 640
    assert _window_starts(1080, 512, 0.5) == [0, 256, 512, 568]
    assert _window_starts(1920, 640, 0.5) == [0, 320, 640, 960, 1280]
    for size, roi, ov in [(1080, 512, 0.5), (97, 32, 0.75), (40, 16, 0.25)]:
        assert _window_starts(size, roi, ov) == jsw._window_starts(size, roi, ov)


def test_gaussian_importance_map():
    m = gaussian_importance_map((32, 48))
    assert m.shape == (32, 48)
    assert m.max() == m[15:17, 23:25].max()
    assert (m > 0).all()
    np.testing.assert_array_equal(m, jsw.gaussian_importance_map((32, 48)))


@pytest.mark.parametrize("fuse_blend", [False, True])
@pytest.mark.parametrize("mode", ["gaussian", "constant"])
def test_blending_reconstructs_identity(rng, mode, fuse_blend):
    """Overlap weights normalize to 1 everywhere."""
    x = rng.rand(2, 40, 56, 3).astype(np.float32)
    out = _swi(x, lambda w: w, roi=(16, 16), num_classes=3, sw_batch_size=4,
               overlap=0.5, mode=mode, fuse_blend=fuse_blend)
    np.testing.assert_allclose(out, x, atol=1e-4)


def test_roi_larger_than_image_single_window(rng):
    x = rng.rand(1, 24, 24, 3).astype(np.float32)
    calls = []

    def pred(w):
        calls.append(tuple(w.shape))
        return w * 2.0

    out = _swi(x, pred, roi=(64, 64), num_classes=3, sw_batch_size=2)
    np.testing.assert_allclose(out, x * 2.0, atol=1e-5)
    assert calls[0][1:] == (24, 24, 3)


def test_overlap_075(rng):
    x = rng.rand(1, 64, 64, 2).astype(np.float32)
    out = _swi(x, lambda w: w, roi=(32, 32), num_classes=2, sw_batch_size=8,
               overlap=0.75)
    np.testing.assert_allclose(out, x, atol=1e-4)


def test_bf16_blend_matches_f32_within_bf16_noise(rng):
    x = rng.rand(2, 40, 56, 3).astype(np.float32)
    pred = lambda w: w * 1.7 - 0.3
    out32 = _swi(x, pred, roi=(16, 16), num_classes=3, sw_batch_size=4)
    t16 = sliding_window_inference(torch.from_numpy(x), pred, roi=(16, 16),
                                   num_classes=3, sw_batch_size=4,
                                   compute_dtype=torch.bfloat16)
    assert t16.dtype == torch.float32
    assert np.abs(out32 - t16.numpy()).max() / np.abs(out32).max() < 0.02


@pytest.mark.parametrize("mode", ["gaussian", "constant"])
def test_fuse_blend_matches_chunked_path(rng, mode):
    """Same windows, weights and f32 accumulation: identical results for a
    batch-independent predictor (the chunked stream pads its last chunk)."""
    x = rng.rand(3, 40, 56, 3).astype(np.float32)
    pred = lambda w: w * 1.7 - 0.3
    base = _swi(x, pred, roi=(16, 16), num_classes=3, sw_batch_size=4,
                overlap=0.5, mode=mode)
    fused = _swi(x, pred, roi=(16, 16), num_classes=3, sw_batch_size=4,
                 overlap=0.5, mode=mode, fuse_blend=True)
    np.testing.assert_allclose(fused, base, atol=1e-6)


def test_matches_jax_blend(rng):
    """Same predictor on both sides; blend sums in another order (1e-5)."""
    x = rng.rand(2, 40, 56, 3).astype(np.float32)
    want = jsw.sliding_window_inference(jnp.asarray(x), lambda w: w * 1.7 - 0.3,
                                        roi=(16, 16), num_classes=3,
                                        sw_batch_size=4, fuse_blend=True)
    got = _swi(x, lambda w: w * 1.7 - 0.3, roi=(16, 16), num_classes=3,
               fuse_blend=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_predictor_must_return_final_logits(rng):
    x = torch.from_numpy(rng.rand(1, 16, 16, 3).astype(np.float32))
    raw = lambda w: Pending(w.to(torch.bfloat16).contiguous())
    with pytest.raises(TypeError):
        sliding_window_inference(x, raw, roi=(16, 16), num_classes=3)
    with pytest.raises(TypeError):  # wrong class count
        sliding_window_inference(x, lambda w: w[..., :2], roi=(16, 16),
                                 num_classes=3)


def test_stats_and_iou_match_jax_with_shift(rng):
    """The evaluator's background drop: preds-1 / masks-1, ignore -1."""
    from mmr_tpu.metrics.confusion import segmentation_stats as jstats
    from mmr_tpu.metrics.iou import iou_score as jiou

    nc = 5
    preds = rng.randint(0, nc + 1, (3, 24, 40))
    masks = rng.randint(0, nc + 1, (3, 24, 40))
    masks[0] = 0  # a frame with only background: zero_division applies
    got = segmentation_stats(torch.from_numpy(preds) - 1,
                             torch.from_numpy(masks) - 1, nc, ignore_index=-1)
    want = jstats(jnp.asarray(preds) - 1, jnp.asarray(masks) - 1, nc,
                  ignore_index=-1)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(iou_score(*got).numpy(),
                               np.asarray(jiou(*want)), atol=1e-7)


class _Videos:
    """Duck-typed evaluator dataset: frame chunks of two short videos."""

    infer_batch_size = 2

    def __init__(self, rng, n_frames=3, hw=(64, 96), n_classes=9):
        from mmr_tpu_torch.data.synthetic import render_frame

        self.items = []
        for v in range(2):
            frames = [render_frame(rng, *hw, n_classes) for _ in range(n_frames)]
            img = np.stack([f[0] for f in frames])
            mask = np.stack([f[1] for f in frames])
            for t0 in range(0, n_frames, self.infer_batch_size):
                t1 = min(t0 + self.infer_batch_size, n_frames)
                self.items.append({"id": f"video_{v}", "t0": t0, "t1": t1,
                                   "image": img[t0:t1], "mask": mask[t0:t1]})

    def __iter__(self):
        return iter(self.items)


def test_run_inference_matches_jax(rng, tmp_path):
    """Same frames (tail chunk of 1 frame included), same converted
    weights, f32 model and blend on both sides: the same per-video and
    per-class IoU."""
    from mmr_tpu.infer.evaluator import run_inference as jax_run_inference
    from mmr_tpu.models.decoders import UnetPlusPlusModel
    from test_torch_models import _fill, _port

    data = _Videos(rng)
    config = {"n_classes": 9, "patch_size": (32, 64), "sw_overlap": 0.5,
              "sw_fp32_blend": True, "results_path": str(tmp_path)}
    jm = UnetPlusPlusModel(num_classes=10, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False),
                            jax.random.key(0), jnp.zeros((1, 32, 64, 3)))
    variables = _fill(shapes, np.random.RandomState(7))
    want = jax_run_inference(jm, jax.tree_util.tree_map(jnp.asarray, variables),
                             data, config, save_plots=False)
    got = run_inference(_port(variables, torch.float32), data, config,
                        save_plots=False, device="cpu")
    assert set(got) == set(want) and set(got["videos"]) == set(want["videos"])
    np.testing.assert_allclose(got["per_class_iou"], want["per_class_iou"],
                               atol=1e-6)
    for v in want["videos"]:
        np.testing.assert_allclose(got["videos"][v]["mean_iou"],
                                   want["videos"][v]["mean_iou"], atol=1e-6)


def test_run_inference_refusals(rng):
    data = _Videos(rng, n_frames=1, hw=(32, 32))
    config = {"n_classes": 9, "patch_size": (32, 32)}
    with pytest.raises(NotImplementedError):
        run_inference(None, data, config, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_inference(None, data, config, save_plots=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_sliding_window_fn(None, (32, 32), 10)
