"""Flagship benchmark of the port: the 200-frame 4K sortie end to end.

Counterpart of the JAX package's ``bench_sortie.py`` (its ``main``),
without the C++ reference run (see ``tools/sortie_bench.py``). Renders a
10 x 20 boustrophedon sortie of 2160x3840 frames (70% along-track, 35%
side overlap, seed 11, JPEG quality 92), runs the port end to end
(``app.run_stitch_application``: grouping -> strips -> global compose ->
crop -> write) ``--runs`` times in this process, and prints ONE JSON line.

Protocol v2: run 1 is cold (the CUDA kernels' nvcc and the graph-cut
solver's g++ build at first use); ``secs_ours`` is the median of the warm
runs (2..N); every run keeps its wall, GT-RMSE (``max_dim=6000``, whole
and per flight line), stage split, the global stage's seam-warp and seam
seconds, peak device memory (``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``), the process's peak RSS (``ru_maxrss``, a
high-water mark over the process so far), the decode thread's busy time,
the frame store's format and bytes, whether the mosaic was streamed into
the encoder (with the encoder's and the finish wait's seconds), the JPEG
codec's build route, and the K1 / K2 launch counts (K2's also by source).

    python -m drone_image_stitch_cpp_tpu_torch.tools.bench_sortie \\
        [--frames-rows 10 --frames-cols 20] [--work DIR] [--runs 4] \\
        [--device cuda] [--ingest-fmt auto|bgr|yuv420] [--fetch-packed] \\
        [--seam-warp prescaled|fullres] [--seam-method graphcut|dp] \\
        [--record PATH]

Nothing is written into the repository's tree but the rendered sortie
under ``--work`` (default ``build/sortie200``, git-ignored); the JSON goes
to ``--record`` only when a path is named.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import time

import numpy as np

from .sortie_bench import gt_rmse_rows, line_rows, log, make_sortie, run_ours

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FRAME_H, FRAME_W = 2160, 3840
GT_MAX_DIM = 6000


def stage_split(records):
    """Aggregate the run's ``... done seconds=`` records into a per-stage
    wall-clock map (strips summed; the per-strip spread is in the raw
    log), rounded to 0.1 s once summed: a step inside a stage (a seam's
    solve, a tile's feed) is many short records."""
    out = {}
    for r in records:
        if "seconds" not in r:
            continue
        stage = r["stage"]
        msg = r["msg"].replace(" done", "")
        if stage.startswith("Strip"):
            key = f"strips:{msg}"
        else:
            key = f"{stage}:{msg}"
        out[key] = out.get(key, 0.0) + r["seconds"]
    return {k: round(v, 1) for k, v in out.items()}


def launch_counts():
    """The kernel wrappers' launch counters since the last
    :func:`zero_launch_counts`: K1, K2 (single and batched), and K2's
    content-mode, float32, I420 and staged-I420 launches among them; K2's
    single-plane form (``warp_planes``) apart, as it is no BGR warp."""
    from ..ops.sift_kernel import orientation_descriptor_flat
    from ..ops.warp_kernel import warp_frame, warp_frames, warp_planes
    return {"sift_orient_desc": orientation_descriptor_flat.launches,
            "warp_affine_plane": warp_planes.launches,
            "warp_affine": warp_frame.launches + warp_frames.launches,
            "warp_affine_batched": warp_frames.launches,
            "warp_affine_nonblack": warp_frame.nonblack_launches,
            "warp_affine_f32": warp_frame.f32_launches,
            "warp_affine_i420": warp_frame.i420_launches,
            "warp_affine_i420_staged": warp_frame.i420_staged_launches}


def k2_by_source(launches):
    """K2's launches of :func:`launch_counts` by the source they read:
    uint8 frames, float32 frames, packed I420 by the staged and by the
    per-tap kernel, and uint8 strips in content mode."""
    i420 = launches["warp_affine_i420"]
    staged = launches["warp_affine_i420_staged"]
    content = launches["warp_affine_nonblack"]
    f32 = launches["warp_affine_f32"]
    return {"u8": launches["warp_affine"] - i420 - content - f32,
            "f32": f32, "i420_staged": staged, "i420_per_tap": i420 - staged,
            "content": content}


def zero_launch_counts():
    """Set every launch counter of both kernel wrappers to 0 (K1's
    mixed-size count too)."""
    from ..ops.sift_kernel import orientation_descriptor_flat
    from ..ops.warp_kernel import warp_frame, warp_frames, warp_planes
    orientation_descriptor_flat.launches = 0
    warp_planes.launches = 0
    orientation_descriptor_flat.mixed_launches = 0
    for name in ("launches", "nonblack_launches", "f32_launches",
                 "i420_launches", "i420_staged_launches"):
        setattr(warp_frame, name, 0)
    warp_frames.launches = 0


def summarize(runs):
    """Protocol v2 over run records (``label`` cold / warm, ``secs``,
    ``gt_rmse`` and the rest): the median of the warm runs, or of all runs
    when none is warm (then ``warm_median`` is None); the lower median for
    an even count, as the JAX harness takes it."""
    true_warm = [rn for rn in runs if rn["label"] == "warm"]
    warm = true_warm or runs
    wsecs = sorted(rn["secs"] for rn in warm)
    med = wsecs[(len(wsecs) - 1) // 2]
    med_run = next(rn for rn in warm if rn["secs"] == med)
    return dict(secs_ours=med, secs_ours_runs=[rn["secs"] for rn in runs],
                cold_secs=runs[0]["secs"],
                warm_median=(med if true_warm else None),
                warm_runs=len(true_warm),
                warm_spread=[wsecs[0], wsecs[-1]],
                gt_rmse_ours=med_run["gt_rmse"],
                peak_device_gib=med_run["peak_device_gib"],
                protocol_version=2)


def _rec(records, msg, stage="Main"):
    return next((r for r in records if r["msg"] == msg
                 and r["stage"] == stage), None)


def measure_run(root, gt, device, label, retries=2, ingest_fmt="auto",
                fetch_packed=False, seam_warp="prescaled",
                seam_method="graphcut", lines=()):
    """One timed ``run_ours`` (``ingest_fmt``, ``fetch_packed``,
    ``seam_warp``, ``seam_method``: its ``RunConfig`` fields) with its
    stage split, GT-RMSE (whole, and over each (y0, y1) ground-truth row
    band of ``lines``: ``gt_rmse_lines``), the global stage's seam-warp
    and seam seconds, peak device memory, peak RSS, decode-thread time,
    the store's format and bytes, the streamed write's encoder and
    finish-wait seconds (None when the mosaic was written after the
    blend), the codec's route and launch counts: (run record, mosaic, the
    run's log records)."""
    import torch

    from ..runtime.device import resolve_devices
    from ..runtime.logging import get_logger

    dev = resolve_devices(device)[0]
    cuda = dev.type == "cuda"
    if cuda:
        # the first CUDA call of a process whose sortie was cached: the
        # allocator's statistics exist only once the context does
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    logger = get_logger()
    rec0 = len(logger._records)
    zero_launch_counts()
    secs, mosaic, rc = run_ours(root, os.path.join(root, "_ours"), device,
                                retries=retries, ingest_fmt=ingest_fmt,
                                fetch_packed=fetch_packed,
                                seam_warp=seam_warp, seam_method=seam_method)
    launches = launch_counts()
    if rc != 0 or mosaic is None:
        raise RuntimeError(f"[sortie] the port's run failed rc={rc}")
    records = logger._records[rec0:]
    rmse, dx, dy, by_line = gt_rmse_rows(mosaic, gt, max_dim=GT_MAX_DIM,
                                         rows=lines)
    decode = _rec(records, "streaming decode") or {}
    streamed = _rec(records, "streamed mosaic written", "GlobalCustom")
    codec = _rec(records, "codec") or {}
    seam_warps = _rec(records, "seam warps done", "GlobalCustom") or {}
    seams = _rec(records, "seams done", "GlobalCustom") or {}
    run = dict(label=label, secs=round(secs, 3), gt_rmse=round(rmse, 3),
               gt_rmse_lines=[round(r, 3) for r in by_line],
               gt_shift=[round(dx, 2), round(dy, 2)],
               mosaic_hw=list(mosaic.shape[:2]),
               stages=stage_split(records),
               peak_device_gib=(round(torch.cuda.max_memory_allocated(dev)
                                      / 2**30, 3) if cuda else None),
               ru_maxrss_gib=round(resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 2**20, 3),
               decode_thread_s=decode.get("decode_seconds"),
               store_fmt=decode.get("fmt"), store_bytes=decode.get("bytes"),
               streamed=streamed is not None,
               encode_s=streamed and streamed["encode_seconds"],
               finish_wait_s=streamed and streamed["finish_wait_seconds"],
               codec_route=codec.get("route"),
               ingest_fmt=ingest_fmt, fetch_packed=fetch_packed,
               seam_warp=seam_warp, seam_method=seam_method,
               seam_warps_s=seam_warps.get("seconds"),
               seams_s=seams.get("seconds"),
               launches=launches, k2_by_source=k2_by_source(launches))
    return run, mosaic, records


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames-rows", type=int, default=10)
    ap.add_argument("--frames-cols", type=int, default=20)
    ap.add_argument("--work", default=os.path.join(_REPO, "build",
                                                   "sortie200"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (every visible card), cuda:N or cpu")
    ap.add_argument("--runs", type=int, default=1,
                    help="end-to-end runs in this process. Run 1 is COLD "
                         "(kernel and solver builds); secs_ours is the "
                         "MEDIAN OF THE WARM runs (2..N). Use --runs >= 4 "
                         "for the protocol (1 cold + >= 3 warm).")
    ap.add_argument("--ingest-fmt", default="auto",
                    choices=("auto", "bgr", "yuv420"),
                    help="the frame store's format (RunConfig.ingest_fmt)")
    ap.add_argument("--fetch-packed", action="store_true",
                    help="fetch the global tiles as packed I420 "
                         "(RunConfig.fetch_packed)")
    ap.add_argument("--seam-warp", default="prescaled",
                    choices=("prescaled", "fullres"),
                    help="the global seam canvas's warp source "
                         "(RunConfig.seam_warp)")
    ap.add_argument("--seam-method", default="graphcut",
                    choices=("graphcut", "dp"),
                    help="the global seams (RunConfig.seam_method)")
    ap.add_argument("--record", default=None,
                    help="also write the JSON line to this path")
    args = ap.parse_args(argv)

    from ..runtime.device import card_name_and_power_limit

    t0 = time.perf_counter()
    root, gt_path = make_sortie(args.work, rows=args.frames_rows,
                                cols=args.frames_cols, frame_h=FRAME_H,
                                frame_w=FRAME_W, device=args.device)
    render_s = time.perf_counter() - t0
    gt = np.load(gt_path)
    with open(os.path.join(root, "meta.json")) as f:
        lines = line_rows(json.load(f))
    out = {"frames": args.frames_rows * args.frames_cols,
           "frame": f"{FRAME_H}x{FRAME_W}", "overlap": "0.70/0.35",
           "render_s": round(render_s, 3),
           "device": args.device, "card": card_name_and_power_limit(),
           "ingest_fmt": args.ingest_fmt, "fetch_packed": args.fetch_packed,
           "seam_warp": args.seam_warp, "seam_method": args.seam_method}
    runs = []
    for k in range(max(1, args.runs)):
        run, mosaic, _ = measure_run(root, gt, args.device,
                                     "cold" if k == 0 else "warm",
                                     ingest_fmt=args.ingest_fmt,
                                     fetch_packed=args.fetch_packed,
                                     seam_warp=args.seam_warp,
                                     seam_method=args.seam_method,
                                     lines=lines)
        runs.append(run)
        out["mosaic_hw"] = run["mosaic_hw"]
        log(f"[sortie] run {k + 1}/{args.runs} ({run['label']}): "
            f"{run['secs']:.1f} s gt_rmse={run['gt_rmse']:.3f} mosaic="
            f"{mosaic.shape} peak={run['peak_device_gib']} GiB rss="
            f"{run['ru_maxrss_gib']} GiB")
        del mosaic
    out.update(summarize(runs), runs=runs)
    line = json.dumps(out)
    if args.record:
        with open(args.record, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
