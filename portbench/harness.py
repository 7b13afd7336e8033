"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the numbers the metric readers take.

The program under test is ``network_interpretation_imagenet_tpu_torch``; it is
imported here, inside :func:`run`, and nowhere else in the harness."""

from __future__ import annotations

import gc
import json
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench import costs, reference as ref
from portbench.spec import Cell, read_metrics
from portbench.trace import DeviceTrace, Spans
from portbench.traffic import ClosedLoop, make_pool

FORBIDDEN = ("jax", "jaxlib", "flax", "network_interpretation_imagenet_tpu")
PORT = "network_interpretation_imagenet_tpu_torch"
# A BO step's start is the GP-EI choice if its EI is within EI_REGRET
# (relative) of the best under a lengthscale whose log marginal likelihood is
# within EI_MLL_SLACK nats of the grid's best (``reference.ei_choice_ok``).
# A step is judged only where the scores observed before it spread (population
# std) by EI_Y_SPREAD or more: below that the normalised targets are f32
# rounding (6e-8 at scores near 1) over a spread floored at 1e-6, EI follows
# the posterior variance alone, and its f32 value at starts a small part of a
# long lengthscale from the observed ones is cancellation noise.
EI_MLL_SLACK, EI_REGRET, EI_Y_SPREAD = 0.5, 1e-3, 1e-4


def forbidden_modules(extra=()) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole word, one of :data:`FORBIDDEN` or of ``extra``."""
    names = set(FORBIDDEN) | set(extra)
    return sorted({m.split(".")[0] for m in list(sys.modules)} & names)


def derived_seeds(seed: int) -> dict:
    """Independent streams from one ``--seed``: the weights, the image pool,
    the sweep's window starts (numpy needs it under 2^32) and the sample the
    check compares."""
    seed = int(seed)
    return {"weights": seed, "pool": seed ^ 0x5DEECE66D, "sweep": seed % (2 ** 31),
            "sample": (seed * 2654435761 + 12345) % (2 ** 32)}


class Context:
    """What the metric readers read: counts the harness made, the host
    clock's times, the device trace and the spans."""

    def __init__(self, cell: Cell, trace: DeviceTrace, spans: Spans) -> None:
        self.cfg, self.traffic, self.net = cell.config, cell.traffic, cell.net
        self.trace, self.spans = trace, spans
        self.setup_s = 0.0
        self.window_s = 0.0
        self.images = 0
        self.evals = 0
        self.forwards: Dict[int, int] = {}   # batch -> forwards the finished work needed
        self.b1_calls: Dict[int, int] = {}   # masks per call -> calls
        self.latencies_ms: List[float] = []  # per finished request, hand-off to answer

    @property
    def traced(self) -> bool:
        return self.trace.enabled and bool(self.trace.kernels)

    def flops(self) -> float:
        """The forward operations of the finished work, by the family's
        ``forward_flops``."""
        per_image = self.net.forward_flops(self.cfg)
        return per_image * sum(b * n for b, n in self.forwards.items())

    def peak_flops(self) -> float:
        """The card's peak in the config's dtype."""
        return costs.PEAK_FLOPS[self.cfg["dtype"]]

    def b2_bound_ms(self) -> Optional[float]:
        """The chain bounds of the finished work in the config's dtype;
        None for a config with no B2 ``chains``."""
        if "chains" not in self.cfg:
            return None
        return sum(costs.b2_bound_ms(self.cfg["chains"], b, self.cfg["dtype"]) * n
                   for b, n in self.forwards.items())

    def b1_bound_ms(self) -> float:
        r, itemsize = self.cfg["resolution"], costs.ITEMSIZE[self.cfg["dtype"]]
        return sum(costs.b1_bound_ms(r, r, 3, k, itemsize) * n for k, n in self.b1_calls.items())


def _window_counts(ctx: Context, images: int, k: int, mask_batch: int) -> None:
    """The forwards and B1 calls that ``images`` finished images of ``k``
    window masks need: one unmasked prediction each, and the masks in
    chunks of ``mask_batch`` (the last one holds the remainder)."""
    ctx.images, ctx.evals = images, images * k
    chunks = [mask_batch] * (k // mask_batch) + ([k % mask_batch] if k % mask_batch else [])
    ctx.forwards = {1: images}
    for c in chunks:
        ctx.forwards[c] = ctx.forwards.get(c, 0) + images
        ctx.b1_calls[c] = ctx.b1_calls.get(c, 0) + images


def _window_check(net, cfg, traffic, seeds, pool, boxes, state, picks, device, control: bool,
                  notes: List[str]) -> dict:
    """The reference's readings on the sampled images. ``picks``: per image,
    the program's row, heatmap and outcomes. The reference segments the image,
    draws its window starts and runs the f32 net of the family ``net`` on
    the image and on every mask; the program's answers (and, with
    ``control``, the fp8 net's in their place) are held against it:

    - ``segments_heatmap_mismatch``: images whose segment count differs, or
      whose heatmap differs from the one the reference sums from its own
      segments and starts and the program's survive outcomes;
    - ``iou_mismatch``: images whose IOU differs from the reference's IOU of
      the program's heatmap;
    - ``outcome_mismatch``: masks whose survive outcome is not ``pred ==
      target``;
    - ``rel_logit_err``: the widest error of any answer, in units of the
      spread (standard deviation over the classes) of the reference's logits
      for that image or mask: the reference's best logit less its logit of
      the program's target, and per mask the gap between the program's
      log-probability of its target and of its prediction (``prob_target``,
      ``prob_max``) and the reference's log-softmax at those classes. (In
      plain logits the error follows each seed's logit scale: one seed's
      weights gave the fp8 control 0.17 and another's the program 0.13.)

    Returns ``{"program": numbers}``, with ``control`` also ``"control"``;
    notes the program's images that an exact number fails."""
    k, frac, thr = traffic["masks_per_image"], traffic["window_fraction"], traffic["bbox_threshold"]
    chunk = int(traffic["check_batch"])
    plain = net.Plain(cfg, state)
    ctl = net.Plain(cfg, state, quantize="fp8") if control else None
    worst = {"program": _blank(), **({"control": _blank()} if control else {})}
    for row, heat, outs in picks:
        i = row["index"]
        image, gt = pool[i % len(pool)], boxes[i % len(pool)]
        disp = ref.normalize_to_uint8(image)
        h, w = disp.shape[:2]
        seg = ref.felzenszwalb(disp, ref.segment_scale(h, w, traffic.get("scale")),
                               traffic["sigma"], traffic["min_size"])
        s = int(seg.max()) + 1
        width = int(frac * s)
        firsts = ref.window_starts(seeds["sweep"] + i, k, s, width)
        img_t, seg_t = torch.from_numpy(image).to(device), torch.from_numpy(seg).to(device)
        firsts_t = torch.from_numpy(firsts).to(device)

        def logits(model):
            """f64 host logits of the unmasked image and of the K masks."""
            masked = [model(ref.masked_images(img_t, seg_t, firsts_t[o:o + chunk], width))
                      for o in range(0, k, chunk)]
            return model(img_t[None])[0].double().cpu(), torch.cat(masked).double().cpu()

        ref0, ref_m = logits(plain)
        log_sm = torch.log_softmax(ref_m, dim=1).numpy()
        spread = ref_m.std(dim=1).numpy()
        answers = {"program": (int(row["target"]), np.asarray(outs.preds, np.int64),
                               np.log(np.asarray(outs.prob_target, np.float64)),
                               np.log(np.asarray(outs.prob_max, np.float64)),
                               np.asarray(outs.survived, bool), np.asarray(heat, np.float32),
                               int(row["num_segments"]), row.get("iou"))}
        if control:
            c0, cm = logits(ctl)
            target = int(c0.argmax())
            preds = cm.argmax(dim=1).numpy()
            c_sm = torch.log_softmax(cm, dim=1).numpy()
            survived = preds == target
            c_heat = ref.summed_heatmap(seg, firsts, width, survived)
            answers["control"] = (target, preds, c_sm[:, target], c_sm.max(axis=1), survived,
                                  c_heat, s, ref.localization_iou(c_heat, gt, thr))
        rows_k = np.arange(k)
        for side, answer in answers.items():
            target, preds, lp_target, lp_pred, survived, got_heat, got_s, got_iou = answer
            nums = worst[side]
            before = dict(nums)
            want_heat = ref.summed_heatmap(seg, firsts, width, survived)
            nums["segments_heatmap_mismatch"] += int(
                got_s != s or not np.array_equal(got_heat, want_heat))
            nums["iou_mismatch"] += int(
                got_iou is None or float(got_iou) != ref.localization_iou(got_heat, gt, thr))
            nums["outcome_mismatch"] += int(np.sum(survived != (preds == target)))
            if side == "program" and nums != before:
                moved = sorted(k for k in nums if nums[k] != before[k])
                notes.append(f"check: image {i} moved {moved}")
            err = max(float((ref0.max() - ref0[target]) / ref0.std()),
                      float((np.abs(lp_target - log_sm[:, target]) / spread).max()),
                      float((np.abs(lp_pred - log_sm[rows_k, preds]) / spread).max()))
            nums["rel_logit_err"] = max(nums["rel_logit_err"], err)
    return worst


def _blank() -> dict:
    return {"segments_heatmap_mismatch": 0, "iou_mismatch": 0, "outcome_mismatch": 0,
            "rel_logit_err": 0.0}


_SPAN_OF = {"segment_image": "segment", "localization_score": "localize"}


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class _Port:
    """The program under test, built for one run: the model and the engine
    in the config's ``dtype`` on the harness's weights, with the harness's
    spans around its calls."""

    def __init__(self, cfg, traffic, state, dev, spans: Spans, engine_hook) -> None:
        dtype = DTYPES.get(cfg.get("dtype"))
        if dtype is None:
            raise ValueError(f"configuration {cfg.get('name')!r} states dtype "
                             f"{cfg.get('dtype')!r}; the engine runs {sorted(DTYPES)}")
        from network_interpretation_imagenet_tpu_torch.config import BOConfig, SegmentConfig
        from network_interpretation_imagenet_tpu_torch.models import create_model
        from network_interpretation_imagenet_tpu_torch.saliency import bo_pipeline, pipeline
        from network_interpretation_imagenet_tpu_torch.saliency import sweep as sweep_module
        from network_interpretation_imagenet_tpu_torch.saliency.engine import SaliencyEngine
        from network_interpretation_imagenet_tpu_torch.segment.common import segment_image
        from network_interpretation_imagenet_tpu_torch.ops.preprocess import to_display_uint8

        self.bundle = create_model(cfg["arch"], "imagenet", num_classes=cfg["num_classes"],
                                   dtype=dtype)
        self.engine = SaliencyEngine(self.bundle, state, mask_batch=int(traffic["mask_batch"]),
                                     compute_dtype=dtype, device=dev)
        if engine_hook is not None:
            engine_hook(self.engine)
        self.collected: list = []
        collect = self.engine.collect

        def recording_collect(handle):
            out = collect(handle)
            self.collected.append(out)
            return out

        self.engine.collect = spans.wrap("collect", recording_collect)
        self.engine.predict_logits_device = spans.wrap("predict",
                                                       self.engine.predict_logits_device)
        self.engine.eval_window_masks_async = spans.wrap("dispatch",
                                                         self.engine.eval_window_masks_async)
        self.seg_cfg = SegmentConfig(method="felzenszwalb", scale=traffic.get("scale"),
                                     sigma=traffic["sigma"], min_size=traffic["min_size"])
        self.bo_cfg = (BOConfig(**{**traffic["bo"], "lengthscale_grid": tuple(
            traffic["bo"]["lengthscale_grid"])}) if "bo" in traffic else None)
        self.sweep_module, self.bo_pipeline, self.pipeline = sweep_module, bo_pipeline, pipeline
        self.segment_image, self.to_display_uint8 = segment_image, to_display_uint8
        # Spans around the sweep's calls into segmentation and localization,
        # where the sweep module still names them; restored by close().
        self.patched = {n: getattr(sweep_module, n) for n in _SPAN_OF
                        if callable(getattr(sweep_module, n, None))}
        for n, fn in self.patched.items():
            setattr(sweep_module, n, spans.wrap(_SPAN_OF[n], fn))

    def close(self) -> None:
        for n, fn in self.patched.items():
            setattr(self.sweep_module, n, fn)
        self.patched = {}


class WindowSweep:
    """``kind: window_sweep``: ``saliency_sweep`` streaming one image at a
    time, K random window masks an image."""

    def __init__(self, port: _Port, traffic, seeds, spans: Spans) -> None:
        self.port, self.traffic, self.seeds, self.spans = port, traffic, seeds, spans
        self.k = int(traffic["masks_per_image"])

    def _sweep(self, items):
        t = self.traffic
        return self.port.sweep_module.saliency_sweep(
            self.port.engine, items, self.port.seg_cfg, num_mask_samples=self.k,
            window_fraction=t["window_fraction"], bbox_threshold=t["bbox_threshold"],
            seed=self.seeds["sweep"], image_batch=1, keep_heatmaps=True, mode="window")

    def warm(self, items) -> None:
        self._sweep(items)

    def window(self, items) -> None:
        with self.spans("sweep"):
            self.res = self._sweep(items)

    def finish(self, ctx: Context, notes: List[str]):
        """Counts into ``ctx``; returns (attempted, failed, sound, rows, picks)."""
        res, collected = self.res, self.port.collected
        rows = list(res.per_image)
        _window_counts(ctx, len(rows), self.k, int(self.traffic["mask_batch"]))
        sound = res.images_failed == 0 and len(collected) == len(rows)
        if not sound:
            notes.append(f"{res.images_failed} images failed; {len(rows)} rows against "
                         f"{len(collected)} collected outcomes")
        rng = np.random.RandomState(self.seeds["sample"])
        pick = sorted(rng.choice(len(rows), size=min(int(self.traffic["check_images"]), len(rows)),
                                 replace=False)) if rows else []
        picks = [(rows[j], res.heatmaps[rows[j]["index"]], collected[j]) for j in pick] if sound else []
        return res.images_total, res.images_failed, sound, len(rows), picks


class BORequests:
    """``kind: bo_request``: the flagship explanation, one image at a time:
    the prediction, Felzenszwalb on the display image, GP-EI BO over window
    starts (the fused loop: pre-samples, then one start an iteration), and
    the heatmap's bbox and IOU. A request's latency runs from its hand-off to
    its IOU on the host."""

    def __init__(self, port: _Port, traffic, seeds, spans: Spans) -> None:
        self.port, self.traffic, self.seeds, self.spans = port, traffic, seeds, spans
        self.done: List[dict] = []
        self.attempted = self.failed = 0
        self.error = ""

    def request(self, i: int, image, gt) -> dict:
        p, t = self.port, self.traffic
        t0 = time.perf_counter()
        with self.spans("predict"):
            target, _ = p.engine.predict_one(image)
        disp = p.to_display_uint8(torch.from_numpy(image)).numpy()
        with self.spans("segment"):
            seg = p.segment_image(disp, p.seg_cfg, p.engine.device)
        with self.spans("bo_call"):
            out, tr = p.bo_pipeline.bo_window_saliency(
                p.engine, image, seg, p.bo_cfg, window_fraction=t["window_fraction"],
                seed=self.seeds["sweep"] + i, target=target)
        with self.spans("localize"):
            iou, _ = p.pipeline.localization_score(out.heatmap, gt, t["bbox_threshold"])
        return {"index": i, "target": int(target), "num_segments": int(out.num_segments),
                "xp": np.asarray(tr.xp), "yp": np.asarray(tr.yp),
                "survived": np.asarray(tr.survived), "heat": np.asarray(out.heatmap),
                "iou": float(iou), "ms": (time.perf_counter() - t0) * 1e3}

    def warm(self, items) -> None:
        """Warm requests, then each candidate bucket of the fused loop twice
        (its eager first call, then its captured graph) on striped segment
        maps of the traffic's ``warm_segment_counts``."""
        for j, (image, _, gt) in enumerate(items):
            self.request(-1 - j, image, gt)
        p, image = self.port, items[0][0]
        h, w = image.shape[:2]
        target, _ = p.engine.predict_one(image)
        for s in self.traffic["warm_segment_counts"]:
            seg = np.broadcast_to((np.arange(w) * int(s) // w).astype(np.int32)[None, :], (h, w))
            for _ in range(2):
                p.bo_pipeline.bo_window_saliency(p.engine, image, np.ascontiguousarray(seg),
                                                 p.bo_cfg, seed=0, target=target)

    def window(self, items) -> None:
        for i, (image, _, gt) in enumerate(items):
            self.attempted += 1
            try:
                self.done.append(self.request(i, image, gt))
            except Exception as e:  # a failed request is counted, not fatal
                self.failed += 1
                self.error = repr(e)

    def finish(self, ctx: Context, notes: List[str]):
        """Counts into ``ctx``; returns (attempted, failed, sound, finished, picks)."""
        bo, n = self.traffic["bo"], len(self.done)
        n_pre, n_iters = int(bo["n_pre_samples"]), int(bo["n_iters"])
        ctx.images, ctx.evals = n, n * (n_pre + n_iters)
        ctx.latencies_ms = [d["ms"] for d in self.done]
        ctx.forwards = {1: n * (1 + n_iters)}
        ctx.forwards[n_pre] = ctx.forwards.get(n_pre, 0) + n
        ctx.b1_calls = {1: n * n_iters}
        ctx.b1_calls[n_pre] = ctx.b1_calls.get(n_pre, 0) + n
        if self.failed:
            notes.append(f"{self.failed} requests failed; the last: {self.error}")
        rng = np.random.RandomState(self.seeds["sample"])
        pick = sorted(rng.choice(n, size=min(int(self.traffic["check_images"]), n),
                                 replace=False)) if n else []
        return self.attempted, self.failed, self.failed == 0, n, [self.done[j] for j in pick]


def _bo_check(net, cfg, traffic, seeds, pool, boxes, state, picks, device, control: bool,
              notes: List[str]) -> dict:
    """The reference's readings on the sampled requests. For each, the
    reference segments the image, draws the loop's random starts, runs the
    f32 net of the family ``net`` on the image and on the window of every
    start the program evaluated, and refits the GP in float64 before each
    step after the pre-samples, on the program's observations so far.
    Numbers:

    - ``segments_heatmap_mismatch``, ``iou_mismatch``: as in the window
      cells, over the trace's starts and survive outcomes;
    - ``draws_mismatch``: requests whose pre-samples are not the draws;
    - ``ei_choice_mismatch_share``: of the judged steps after the
      pre-samples (see :data:`EI_Y_SPREAD`; 0 where none is judged), the
      share whose start is not the GP-EI choice given the observations
      before it (or, where that choice was already observed, not the step's
      draw), by ``reference.ei_choice_ok`` with :data:`EI_MLL_SLACK` and
      :data:`EI_REGRET`. A share, since the steps judged vary from 5 to 90 of
      a run's 120 with how often the scores saturate;
    - ``rel_logit_err``: the widest error, in units of the spread of the
      reference's logits for that image or window (as in the window cells):
      the reference's best logit less its logit of the target; per
      evaluation, the program's log-probability of the target against the
      reference's log-softmax; and where the program's survive outcome
      disagrees with the reference's argmax, the reference's logit distance
      from the tie.

    With ``control`` two loops of the reference's own are held to the same
    numbers: ``control``, the fp8 net running GP-EI, and
    ``proposals_drawn``, the f32 net in a loop that takes each step's draw
    in place of the EI choice (a loop without GP-EI). Notes how many steps
    were judged, and each of the program's steps that did not match."""
    bo = traffic["bo"]
    n_pre, n_iters = int(bo["n_pre_samples"]), int(bo["n_iters"])
    grid, alpha, eps = bo["lengthscale_grid"], float(bo["alpha"]), float(bo["epsilon"])
    frac, thr = traffic["window_fraction"], traffic["bbox_threshold"]
    plain = net.Plain(cfg, state)
    ctl = net.Plain(cfg, state, quantize="fp8") if control else None
    worst = {"program": _bo_blank()}
    if control:
        worst.update(control=_bo_blank(), proposals_drawn=_bo_blank())
    judged, missed = {side: 0 for side in worst}, {side: 0 for side in worst}
    for d in picks:
        i = d["index"]
        image, gt = pool[i % len(pool)], boxes[i % len(pool)]
        disp = ref.normalize_to_uint8(image)
        h, w = disp.shape[:2]
        seg = ref.felzenszwalb(disp, ref.segment_scale(h, w, traffic.get("scale")),
                               traffic["sigma"], traffic["min_size"])
        s = int(seg.max()) + 1
        width, upper = int(frac * s), int(0.6 * s)
        draws = ref.bo_draws(seeds["sweep"] + i, upper, n_pre + n_iters)
        img_t, seg_t = torch.from_numpy(image).to(device), torch.from_numpy(seg).to(device)

        def masked_logits(model, starts):
            firsts = torch.from_numpy(np.asarray(starts, np.int32)).to(device)
            return model(ref.masked_images(img_t, seg_t, firsts, width)).double().cpu()

        def own_loop(model, propose):
            """The reference's loop on ``model``: (target, xp, yp, survived,
            heatmap, segments, IOU)."""
            target = int(model(img_t[None])[0].argmax())

            def evaluate(starts):
                lg = masked_logits(model, starts)
                return (torch.softmax(lg, dim=1)[:, target].numpy(),
                        (lg.argmax(dim=1) == target).numpy())

            xs, ys, surv = ref.bo_trajectory(evaluate, draws, n_pre, n_iters, upper, grid, alpha,
                                             eps, propose=propose)
            heat = ref.summed_heatmap(seg, xs.astype(np.int64), width, surv)
            return target, xs, ys, surv, heat, s, ref.localization_iou(heat, gt, thr)

        ref0 = plain(img_t[None])[0].double().cpu()
        answers = {"program": (d["target"], d["xp"], d["yp"], d["survived"], d["heat"],
                               d["num_segments"], d["iou"])}
        if control:
            answers["control"] = own_loop(ctl, "ei")
            answers["proposals_drawn"] = own_loop(plain, "draw")
        for side, (target, xp, yp, surv, heat, got_s, got_iou) in answers.items():
            nums = worst[side]
            xp_f = np.asarray(xp, np.float64)
            xp_i = xp_f.astype(np.int64)
            surv = np.asarray(surv, bool)
            nums["segments_heatmap_mismatch"] += int(got_s != s or not np.array_equal(
                np.asarray(heat, np.float32), ref.summed_heatmap(seg, xp_i, width, surv)))
            nums["iou_mismatch"] += int(float(got_iou) != ref.localization_iou(heat, gt, thr))
            nums["draws_mismatch"] += int(not np.array_equal(xp_i[:n_pre], draws[:n_pre]))
            yp_f = np.asarray(yp, np.float64)
            for t in range(n_pre, len(xp_f)):
                if np.std(yp_f[:t]) < EI_Y_SPREAD:
                    continue
                judged[side] += 1
                if not ref.ei_choice_ok(xp_f[:t], yp_f[:t], float(xp_f[t]), float(draws[t]),
                                        upper, grid, alpha, eps, EI_MLL_SLACK, EI_REGRET):
                    missed[side] += 1
                    if side == "program":
                        notes.append(f"check: request {i} step {t} took {xp_f[t]:g} after "
                                     f"{xp_i[:t].tolist()} (score spread {np.std(yp_f[:t]):.3g}), "
                                     "not GP-EI's choice")
            lg = masked_logits(plain, xp_i)
            top2 = torch.topk(lg, 2, dim=1).values
            at_target = lg[:, target]
            ref_surv = (lg.argmax(dim=1) == target).numpy()
            flips = np.where(surv & ~ref_surv, (top2[:, 0] - at_target).numpy(),
                             np.where(~surv & ref_surv, (at_target - top2[:, 1]).numpy(), 0.0))
            err_y = np.abs(np.log(np.asarray(yp, np.float64))
                           - torch.log_softmax(lg, dim=1)[:, target].numpy())
            spread = lg.std(dim=1).numpy()
            nums["rel_logit_err"] = max(nums["rel_logit_err"],
                                        float((ref0.max() - ref0[target]) / ref0.std()),
                                        float((err_y / spread).max()),
                                        float((flips / spread).max()))
    for side, nums in worst.items():
        nums["ei_choice_mismatch_share"] = missed[side] / judged[side] if judged[side] else 0.0
    notes.append("check: GP-EI steps missed of judged " + ", ".join(
        f"{k} {missed[k]}/{judged[k]}" for k in worst))
    return worst


def _bo_blank() -> dict:
    return {"segments_heatmap_mismatch": 0, "iou_mismatch": 0, "draws_mismatch": 0,
            "ei_choice_mismatch_share": 0.0, "rel_logit_err": 0.0}


def _within(numbers: dict, limits: dict) -> bool:
    """Whether every number is at most its limit (a number without one fails)."""
    return all(limits.get(n) is not None and v <= limits[n] for n, v in numbers.items())


def _build_kernels() -> Dict[str, float]:
    """The port's CUDA kernels, built or found in its build directory: the
    seconds each compile took (0.0 where it was already built)."""
    from network_interpretation_imagenet_tpu_torch.ops import _cuda_build

    return _cuda_build.build()


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, control: bool = False, engine_hook: Optional[Callable] = None) -> dict:
    """One run. Returns ``{"line": the result object, "checks": [...],
    "readings": {...}, "verdicts": {...}, "notes": [...]}``: ``readings``
    and ``verdicts`` hold, for the program and with ``control`` for the
    reference's stand-ins (the fp8 control, and in the BO cells the loop
    without GP-EI), the compared numbers and whether the cell's limits pass
    them. ``device=None`` is the card. ``engine_hook(engine)`` may wrap the
    engine's methods (the fault tests)."""
    dev = torch.device("cuda" if device is None else device)
    cfg, traffic = cell.config, cell.traffic
    drivers = {"window_sweep": WindowSweep, "bo_request": BORequests}
    if traffic["kind"] not in drivers:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    seeds = derived_seeds(seed)
    spans = Spans()
    dtrace = DeviceTrace(trace and dev.type == "cuda")
    ctx = Context(cell, dtrace, spans)
    notes: List[str] = []

    # Set-up: the kernels, weights and images from the seed on the device,
    # BatchNorm statistics from the first images, the engine, and warm calls.
    stages = Spans()
    with stages("kernels"):
        built = {n: t for n, t in (_build_kernels() if dev.type == "cuda" else {}).items() if t}
    if built:
        notes.append("set-up compiled " + ", ".join(f"{n} ({t:.1f} s)" for n, t in built.items())
                     + ": a checkout's first run, whose setup_s is not a warm one")
    with stages("weights"):
        state = ref.make_weights(cell.net, cfg, seeds["weights"], dev)
    n_cal, n_warm = int(traffic["calibration_images"]), int(traffic["warm_images"])
    with stages("images"):
        images, boxes = make_pool(n_cal + n_warm + int(traffic["pool_images"]),
                                  cfg["resolution"], seeds["pool"], dev)
    with stages("calibration"):
        ref.calibrate(cell.net, cfg, state, torch.from_numpy(images[:n_cal]).to(dev))
    with stages("engine"):
        port = _Port(cfg, traffic, state, dev, spans, engine_hook)
    driver = drivers[traffic["kind"]](port, traffic, seeds, spans)
    try:
        warm = [(images[i], None, tuple(int(v) for v in boxes[i]))
                for i in range(n_cal, n_cal + n_warm)]
        with stages("warm"):
            driver.warm(warm)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        port.collected.clear()
        spans.spans.clear()
        ctx.setup_s = time.perf_counter() - t_start
        notes.append("set-up: " + ", ".join(f"{n} {(b - a) / 1e9:.3f} s" for n, a, b in stages.spans))

        # The window: a closed loop of one caller.
        pool, pool_boxes = images[n_cal + n_warm:], boxes[n_cal + n_warm:]
        loop = ClosedLoop(pool, pool_boxes, seconds)
        with dtrace():
            t0 = time.perf_counter()
            driver.window(loop.items())
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ctx.window_s = time.perf_counter() - t0
    finally:
        port.close()
    if loop.wrapped:
        notes.append(f"the pool of {len(pool)} images ran out; images repeated")
    attempted, failed, sound, finished, picks = driver.finish(ctx, notes)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # The check, once the window has closed and the program's state is freed.
    del port, driver, warm
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    check = _window_check if traffic["kind"] == "window_sweep" else _bo_check
    readings = check(cell.net, cfg, traffic, seeds, pool, pool_boxes, state, picks, dev, control,
                     notes)
    check_s = time.perf_counter() - t_check

    verdicts = {side: _within(nums, cell.limits) for side, nums in readings.items()}
    want = min(int(traffic["check_images"]), finished)
    correct = sound and bool(picks) and len(picks) == want and verdicts["program"]
    checks = [(name, value, cell.limits.get(name)) for name, value in readings["program"].items()]
    metrics = read_metrics(cell, "per_layer" if trace else "end_to_end", ctx)
    found = forbidden_modules()   # after the check and the metric readers have run
    line = {"correct": bool(correct) and not found, "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics,
            "device": _device(dev, peak, dtrace if trace else None)}
    if trace and dtrace.kernels:
        line["breakdown"] = {"device_ops": dtrace.top_ops(), "idle_gaps": dtrace.idle_gaps(spans)}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return {"line": line, "checks": checks, "readings": readings, "verdicts": verdicts,
            "notes": notes, "forbidden": found, "check_s": check_s, "images": finished,
            "setup_s": ctx.setup_s, "window_s": ctx.window_s, "built": built}


def report(out: dict, stdout=None, stderr=None) -> int:
    """Prints a run's notes and checks on standard error and its line as the
    last line of standard output; returns the exit code. Where ``jax``,
    ``jaxlib``, ``flax`` or the JAX package is loaded by now (read again
    here, as the line is printed), it names them and prints no line."""
    stdout, stderr = stdout or sys.stdout, stderr or sys.stderr
    found = sorted(set(out["forbidden"]) | set(forbidden_modules()))
    if found:
        print(f"portbench: loaded by the end of the run: {found}", file=stderr)
        return 3
    for note in out["notes"]:
        print(f"portbench: {note}", file=stderr)
    print(f"portbench: {out['images']} images in {out['window_s']:.3f} s; set-up "
          f"{out['setup_s']:.3f} s; check {out['check_s']:.3f} s", file=stderr)
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=stderr)
    stderr.flush()
    print(json.dumps(out["line"]), file=stdout, flush=True)
    return 0


def _device(dev, peak: int, dtrace: Optional[DeviceTrace]) -> dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
               "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if dtrace is not None and dtrace.enabled:
        out["busy_s"] = dtrace.union_ms() / 1e3
        out["window_s"] = dtrace.window_s
    return out
