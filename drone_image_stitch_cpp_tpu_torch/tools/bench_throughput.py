"""Throughput benchmark of the port: detect + match + RANSAC + 4K warp, in
frames/s.

Counterpart of the JAX package's ``bench.py``. Prints ONE JSON line on
stdout with bench.py's keys ``metric``, ``value``, ``unit`` and
``vs_baseline``; everything else goes to stderr.

- The port (:func:`bench_torch`), for each batch of 8 gray 4K frames
  (:func:`make_frames`): an area resize to the 0.45 MP work size and an
  edge pad to multiples of 128 (bench.py's ``_prep``), one batched detect
  at 2200 features (K1), the 7 neighbour pairs matched (kNN-2, ratio 0.75)
  and fitted by similarity RANSAC (threshold 4 work px, 512 hypotheses,
  pair i's samples from a generator seeded i) as one batch, then frame
  i + 1 warped at full 4K by the work-resolution model of pair i, as
  bench.py does, all 7 in one launch of K2's single-plane form with the
  models inverted on the card, and each warp summed.
- The baseline (:func:`bench_opencv`): the same work through OpenCV on
  this host's CPU with ``cv2.setNumThreads(os.cpu_count())``, best of 3.

``value`` is the port's frames/s from the better of the single-batch time
and the queued time (5 batches queued on the stream, one synchronise);
``vs_baseline`` is it over OpenCV's. The stage times (prep, detect,
register, total) stop each clock after ``torch.cuda.synchronize()``; the
synchronising calls of one batch are counted stage by stage under
``torch.cuda.set_sync_debug_mode("warn")``.

    python -m drone_image_stitch_cpp_tpu_torch.tools.bench_throughput \\
        [--device cuda]

``--device cuda`` (the default) needs a card and fails without one;
``--device cpu`` runs the kernels' plain versions (the tests call the
functions below at cut sizes: every size is a parameter whose default is
bench.py's). The frames/s is the card's named on stderr; the JAX package's
record (``BENCH_r*.json``) was taken on a TPU v5e and is not compared
with it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import match as M
from ..ops import ransac as R
from ..ops.features import detect_and_describe_batched
from ..ops.resize import resize_area, scale_for_megapixels
from ..ops.warp_kernel import warp_planes
from ..runtime.device import describe_device, resolve_device
from .bench_sortie import launch_counts

N_FRAMES = 8
FRAME_H, FRAME_W = 2160, 3840          # 4K
SIFT_FEATURES = 2200                   # visible preset
REG_MPX = 0.45                         # visible preset registration resol
RATIO = 0.75
RANSAC_THRESH = 4.0                    # work px
N_HYP = 512
PIPE_REPS = 5
FP32_OPS_PER_S = 67e12                 # H100 SXM float32, no tensor cores
METRIC = "frames/sec detect+match+warp @4K"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_frames(n_frames=N_FRAMES, frame_h=FRAME_H, frame_w=FRAME_W,
                seed=3):
    """bench.py's frames: ``n_frames`` gray float32 (frame_h, frame_w)
    crops of one ``synthetic_ortho``, each 64 px lower and 256 px further
    right than the one before."""
    from ..utils.synthetic import synthetic_ortho
    big = synthetic_ortho(h=frame_h + 64 * n_frames,
                          w=frame_w + 256 * n_frames, seed=seed)
    gray = (0.114 * big[..., 0] + 0.587 * big[..., 1]
            + 0.299 * big[..., 2]).astype(np.float32)
    return [gray[64 * i:64 * i + frame_h, 256 * i:256 * i + frame_w]
            for i in range(n_frames)]


def work_geometry(frame_h, frame_w, reg_mpx=REG_MPX):
    """(scale, work h, work w, padded h, padded w): the frames' size at
    ``reg_mpx`` megapixels and its edge pad to multiples of 128."""
    scale = scale_for_megapixels(frame_h, frame_w, reg_mpx)
    wh, ww = int(round(frame_h * scale)), int(round(frame_w * scale))
    return scale, wh, ww, -(-wh // 128) * 128, -(-ww // 128) * 128


def sample_banks(n_pairs, n_hyp=N_HYP):
    """(n_pairs, n_hyp, 2) RANSAC sample integers, pair i's drawn from a
    generator seeded i (bench.py keys pair i with ``PRNGKey(i)``)."""
    from ..pipeline.pairgraph import sample_banks as draw
    return torch.cat([draw(1, n_hyp, i) for i in range(n_pairs)])


def flop_estimate(n, frame_h, frame_w, n_features, bh, bw):
    """bench.py's useful-FLOP estimate of one batch: matcher distance
    products, blur taps, warp arithmetic and descriptor terms."""
    k = n_features
    taps = 13
    return ((n - 1) * 2.0 * k * k * 128
            + n * sum(2 * 2 * taps * (bh >> o) * (bw >> o) * 6
                      for o in range(4))
            + (n - 1) * 2.0 * frame_h * frame_w * 8
            + n * 4125 * (96 * 128) * 60)


def prep(frames, geometry):
    """bench.py's ``_prep`` of a (N, H, W) float32 batch: the area resize
    to the work size and the edge pad to the padded size of ``geometry``
    (:func:`work_geometry`)."""
    _, wh, ww, bh, bw = geometry
    small = resize_area(frames, wh, ww, channels_last=False)
    return F.pad(small[:, None], (0, bw - ww, 0, bh - wh),
                 mode="replicate")[:, 0]


def register(feats, banks):
    """Neighbour pairs (i, i + 1) of a batch's features matched (kNN-2,
    ratio test) and fitted by similarity RANSAC with the (N - 1, n_hyp, 2)
    sample ``banks``, all pairs as one batch: (RansacResult, ratio-test
    survivors (N - 1,))."""
    m = M.knn2_ratio(feats.desc[:-1], feats.valid[:-1], feats.desc[1:],
                     feats.valid[1:], RATIO)
    src, dst, good = M.gather_correspondences(feats.xy[:-1], feats.xy[1:], m)
    return (R.ransac(src, dst, good, banks, "similarity", RANSAC_THRESH),
            good.sum(dim=-1))


def warp_sums(frames, models):
    """Frames 1.. of a (N, H, W) batch warped at full size by the
    work-resolution models of pairs 0.. (``models[:, :2]``, as bench.py:111
    does), all in one K2 launch, and each warp summed: (N - 1,)."""
    h, w = frames.shape[1:]
    return warp_planes(frames[1:], models[:, :2, :], h, w).sum(dim=(1, 2))


def bench_torch(frames, device="cuda", banks=None, n_features=SIFT_FEATURES,
                reg_mpx=REG_MPX, reps=3, pipe_reps=PIPE_REPS):
    """The port's path on ``frames`` (the list of :func:`make_frames`):
    one warm-up batch, the stage probes (each the mean of ``reps``), the
    single-batch time and the queued time (``pipe_reps`` batches, one
    synchronise). ``banks``: optional (n - 1, 512, 2) RANSAC samples
    (default :func:`sample_banks`).

    Returns a dict: ``fps``; ``stages_ms`` (prep, detect: prep + detect,
    register: prep + detect + match + RANSAC, warp: total - register,
    total, queued: per batch); ``syncs`` of one batch by stage (None off
    the card); the batch's ``models`` (n - 1, 3, 3), ``n_good``,
    ``n_inliers``, ``ok`` and ``warp_sums`` as numpy; ``launches`` of one
    batch (K1, K2's single-plane form); the work geometry; ``gflop``;
    ``device``.
    """
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    n = len(frames)
    fh, fw = frames[0].shape
    geometry = work_geometry(fh, fw, reg_mpx)
    scale, wh, ww, bh, bw = geometry
    info = describe_device(dev)
    log(f"[throughput] device {info}")
    log(f"[throughput] {n} frames {fh}x{fw}, work res {wh}x{ww} padded "
        f"{bh}x{bw} scale={scale:.4f}, {n_features} features")
    frames_dev = torch.from_numpy(np.stack(frames)).to(dev)
    banks = (sample_banks(n - 1) if banks is None
             else torch.as_tensor(banks)).to(dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def detect(f):
        return detect_and_describe_batched(prep(f, geometry), n_features)

    def full(f):
        res, n_good = register(detect(f), banks)
        return res, n_good, warp_sums(f, res.model)

    def timeit(fn, k=reps):
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
            sync()
        return (time.perf_counter() - t0) / k

    def count_syncs(fn):
        """(fn(), synchronising calls it made; None off the card)."""
        if not cuda:
            return fn(), None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return out, sum("called a synchronizing CUDA operation"
                        in str(w.message) for w in caught)

    res, _, _ = full(frames_dev)                    # warm-up (kernel builds)
    sync()
    if cuda and count_syncs(lambda: frames_dev[0, 0, 0].item())[1] != 1:
        raise RuntimeError("the sync count does not see a tensor.item()")
    log(f"[throughput] warm-up inliers: {res.n_inliers.tolist()}")

    # one batch stage by stage: its synchronising calls and launches
    before = launch_counts()
    small, s_prep = count_syncs(lambda: prep(frames_dev, geometry))
    feats, s_detect = count_syncs(
        lambda: detect_and_describe_batched(small, n_features))
    (res, n_good), s_reg = count_syncs(lambda: register(feats, banks))
    sums, s_warp = count_syncs(lambda: warp_sums(frames_dev, res.model))
    sync()
    after = launch_counts()
    launches = {k: after[k] - before[k]
                for k in ("sift_orient_desc", "warp_affine_plane")}
    syncs = (None if not cuda else
             {"prep": s_prep, "detect": s_detect, "register": s_reg,
              "warp": s_warp})
    log(f"[throughput] synchronising calls of one batch: {syncs}; "
        f"launches {launches}")
    del small, feats

    probes = (lambda: prep(frames_dev, geometry).sum(),
              lambda: detect(frames_dev).desc.sum(),
              lambda: register(detect(frames_dev), banks))
    for probe in probes:
        probe()                                     # warm every probe
    sync()
    t_prep, t_detect, t_reg = (timeit(p) for p in probes)
    t_total = timeit(lambda: full(frames_dev))

    def queued(k):
        outs = [full(frames_dev) for _ in range(k)]
        sync()
        return outs

    queued(1)
    t_pipe = timeit(lambda: queued(pipe_reps)) / pipe_reps
    t_best = min(t_total, t_pipe)
    stages = {"prep": t_prep * 1e3, "detect": t_detect * 1e3,
              "register": t_reg * 1e3, "warp": (t_total - t_reg) * 1e3,
              "total": t_total * 1e3, "queued": t_pipe * 1e3}
    log(f"[throughput] stage times per {n}-frame batch (ms): prep "
        f"{stages['prep']:.3f} | detect(+prep) {stages['detect']:.3f} | "
        f"register(prep+detect+match+ransac) {stages['register']:.3f} | "
        f"warp x{n - 1} {stages['warp']:.3f} | total {stages['total']:.3f}")
    log(f"[throughput] queued x{pipe_reps}: {stages['queued']:.3f} ms/batch "
        f"(single batch {stages['total']:.3f} ms)")
    flops = flop_estimate(n, fh, fw, n_features, bh, bw)
    if cuda:
        log(f"[throughput] useful-FLOP estimate {flops / 1e9:.1f} GFLOP -> "
            f"{flops / t_best / FP32_OPS_PER_S * 100:.2f}% of the card's "
            f"float32 rate outside the tensor cores (67 TFLOP/s)")
    fps = n / t_best
    log(f"[throughput] {t_best * 1e3:.3f} ms/batch -> {fps:.3f} frames/s "
        f"on {info['kind']}")
    return {"fps": fps, "stages_ms": stages, "syncs": syncs,
            "models": res.model.cpu().numpy(),
            "n_good": n_good.cpu().numpy(),
            "n_inliers": res.n_inliers.cpu().numpy(),
            "ok": res.ok.cpu().numpy(), "warp_sums": sums.cpu().numpy(),
            "launches": launches, "scale": scale, "work_hw": (wh, ww),
            "padded_hw": (bh, bw), "gflop": flops / 1e9, "device": info}


def bench_opencv(frames, n_features=SIFT_FEATURES, reg_mpx=REG_MPX,
                 reps=3):
    """bench.py's baseline: the same work through OpenCV on this host's
    CPU (SIFT, BFMatcher kNN-2 + ratio, estimateAffinePartial2D RANSAC,
    warpAffine at full size), one warm-up pass and the best of ``reps``.
    Returns frames/s. Raises when cv2 is missing or a pair finds no
    model, which would leave its warp out of the baseline."""
    import cv2

    cores = os.cpu_count() or 1
    cv2.setNumThreads(cores)
    fh, fw = frames[0].shape
    scale = min(1.0, (reg_mpx * 1e6 / (fh * fw)) ** 0.5)
    sift = cv2.SIFT_create(nfeatures=n_features)
    bf = cv2.BFMatcher()

    def one_pass():
        kps, descs = [], []
        for f in frames:
            small = cv2.resize(f, None, fx=scale, fy=scale,
                               interpolation=cv2.INTER_AREA)
            kp, de = sift.detectAndCompute(small.astype(np.uint8), None)
            kps.append(kp)
            descs.append(de)
        warped = 0
        for i in range(len(frames) - 1):
            if descs[i] is None or descs[i + 1] is None:
                continue
            knn = bf.knnMatch(descs[i], descs[i + 1], k=2)
            good = [m for m, nn in knn if m.distance < RATIO * nn.distance]
            if len(good) < 4:
                continue
            src = np.float32([kps[i][m.queryIdx].pt for m in good])
            dst = np.float32([kps[i + 1][m.trainIdx].pt for m in good])
            mo, _ = cv2.estimateAffinePartial2D(
                src, dst, method=cv2.RANSAC,
                ransacReprojThreshold=RANSAC_THRESH, maxIters=4000,
                confidence=0.995, refineIters=80)
            if mo is not None:
                cv2.warpAffine(frames[i + 1], mo.astype(np.float32),
                               (fw, fh))
                warped += 1
        return warped

    warped = one_pass()
    if warped != len(frames) - 1:
        raise RuntimeError(f"OpenCV baseline: {warped} of "
                           f"{len(frames) - 1} pairs found a model")
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        one_pass()
        best = min(best, time.perf_counter() - t0)
    fps = len(frames) / best
    log(f"[throughput] opencv cpu: {best * 1e3:.3f} ms/batch (best of "
        f"{reps}) -> {fps:.3f} frames/s; cv2 {cv2.__version__}, "
        f"{cores} cores (os.cpu_count, cv2.setNumThreads)")
    return fps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the current card), cuda:N, or cpu (the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)       # no card: DeviceUnavailableError
    frames = make_frames()
    fps = bench_torch(frames, dev)["fps"]
    fps_cpu = bench_opencv(frames)
    print(json.dumps({"metric": METRIC, "value": round(fps, 3),
                      "unit": "frames/s",
                      "vs_baseline": round(fps / fps_cpu, 3)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
