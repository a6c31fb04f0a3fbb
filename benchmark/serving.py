"""What the serving entries share: the predictor as the serve CLI assembles
it (seeded weights instead of files), the slide schedule, the host pools,
the sample of served slides kept for the check, and the check itself."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

from benchmark import arith, weights
from benchmark.reference import kmeans as ref_kmeans
from benchmark.reference import vis as ref_vis

SEED_MOD = 2 ** 32
#: one file a backbone kind, ``<kind>.py``
BACKBONES = Path(__file__).resolve().parent / "backbones"
_KINDS: dict = {}


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent host stream of the run's seed."""
    return np.random.default_rng([seed % SEED_MOD, seed // SEED_MOD, stream])


def gen(seed: int, stream: int, device) -> torch.Generator:
    """An independent generator of the run's seed on ``device``."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream * 7919) % (2 ** 63))


def vis_shape(cfg: dict) -> dict:
    v = cfg["vis"]
    return {"dim": v["input_dim"], "depth": v["depth"], "heads": v["nheads"],
            "dim_f": v["dim_f"], "dim_s": v["dim_s"], "dim_c": v["dim_c"],
            "genes": v["num_outputs"]}


def fold_weights(cfg: dict, seed: int, device) -> list[dict]:
    v = cfg["vis"]
    return [weights.vis_fold(gen(seed, 100 + i, device), tokens=v["num_clusters"],
                             **vis_shape(cfg)) for i in range(v["folds"])]


def backbone_kind(cfg: dict):
    """The module of the configuration's backbone kind,
    ``backbones/<cfg["backbone"]["kind"]>.py``: a new backbone is a new file
    there.  With ``b`` the configuration's ``backbone`` group, it gives

    - ``weights(b, gen)``: the seeded tree, drawn on ``gen``'s device and
      handed alike to the program and to the reference;
    - ``extractor(b, params, on, device)``: the program's extractor over
      ``params``, assembled as ``cli/serve.build_extractor`` does with the
      serving kernel set ``on``, and ``on`` less the kernels this backbone
      does not run;
    - ``reference(b, params, u8, device, mode)``: (B, H, W, 3) uint8
      patches, on the host or the device, -> (B, feature_dim) f32 on
      ``device``, every product under ``mode`` (``reference.numerics``:
      ``float32``, ``tf32``, ``fp8``); handed a block at a time;
    - ``work(b, n)``: (flops by dtype, bytes) of the extractor over ``n``
      patches, for the roofline metrics."""
    path = BACKBONES / f"{cfg['backbone']['kind']}.py"
    if path not in _KINDS:
        if not path.is_file():
            raise ValueError(f"backbone kind {path.stem!r}: no file {path}")
        spec = importlib.util.spec_from_file_location(f"benchmark_backbone_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _KINDS[path] = mod
    return _KINDS[path]


def backbone_weights(cfg: dict, seed: int, device) -> dict:
    return backbone_kind(cfg).weights(cfg["backbone"], gen(seed, 1, device))


def build_predictor(cfg: dict, backbone: dict | None, folds: list[dict], device):
    """The predictor of ``cli.serve.build_predictor``: its kernel set
    (``serving_kernels``), the extractor of ``build_extractor`` (the
    backbone kind's ``extractor``), the folds at the serving compute dtype;
    the weights are the seeded ones, not a file's.  ``backbone`` None: no
    extractor (a predictor of features)."""
    from sequoia_tpu_torch.cli.serve import SERVING_KERNELS, serving_kernels
    from sequoia_tpu_torch.models import vis
    from sequoia_tpu_torch.serve import SlidePredictor

    v = cfg["vis"]
    vcfg = vis.ViSConfig(num_outputs=v["num_outputs"], input_dim=v["input_dim"],
                         depth=v["depth"], nheads=v["nheads"], dim_f=v["dim_f"],
                         dim_s=v["dim_s"], dim_c=v["dim_c"], num_clusters=v["num_clusters"],
                         compute_dtype=v["compute_dtype"])
    models = [(vcfg, p) for p in folds]
    on, why = serving_kernels(device, models, SERVING_KERNELS, "vis")
    b = cfg["backbone"]
    extractor = None
    if backbone is not None:
        extractor, on = backbone_kind(cfg).extractor(b, backbone, on, device)
    k = cfg["kmeans"]
    pred = SlidePredictor(extractor, models, model_type="vis", n_clusters=k["n_clusters"],
                          max_patches=cfg["max_patches"], patch_size=b["patch_size"],
                          use_pallas_kmeans="lloyd_stats" in on,
                          use_fused_vis="vis_blocks_fused" in on, device=device)
    return pred, on, why


def schedule(traffic: dict, seed: int, pool: int):
    """Endless ``(n, offset, last)`` of the slides.  The cycle's groups each
    hold ``full_per_group`` slides of ``full`` patches and one pair of
    biopsies of ``pairs``, so every group holds the same patches; the seed
    orders the pairs in each round of them, the slides in each group, and
    draws each slide's window of the pool.  ``last`` marks a group's last
    slide, where a window may close."""
    c = traffic["cycle"]
    r = rng(seed, 2)
    while True:
        for p in r.permutation(len(c["pairs"])):
            group = [c["full"]] * c["full_per_group"] + list(c["pairs"][p])
            order = r.permutation(len(group))
            for j, i in enumerate(order):
                n = group[i]
                yield n, int(r.integers(0, pool - n + 1)), j == len(order) - 1


def _patch_chunks(seed: int, n: int, size: int, device, chunk: int):
    """``(start, patches)`` of ``n`` H&E-like uint8 (m, size, size, 3)
    patches on the device, ``chunk`` at a time: a stain colour per patch
    from a palette of pinks and purples, a coarse texture of nuclei-dark
    blobs scaled up, and pixel noise."""
    palette = torch.tensor([[233, 150, 190], [200, 120, 180], [150, 90, 160], [240, 200, 220],
                            [120, 60, 140], [225, 170, 200], [180, 110, 170], [245, 235, 240]],
                           dtype=torch.float32, device=device)
    dark = torch.tensor([-70.0, -60.0, -30.0], device=device)
    g = gen(seed, 3, device)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        col = palette[torch.randint(len(palette), (m,), generator=g, device=device)]
        col = col + 12.0 * torch.randn((m, 3), generator=g, device=device)
        coarse = torch.randn((m, 1, size // 16, size // 16), generator=g, device=device)
        tex = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                              align_corners=False)[:, 0, :, :, None]
        img = col[:, None, None, :] + tex.clamp(min=0) * dark
        img = img + 10.0 * torch.randn((m, size, size, 3), generator=g, device=device)
        yield s, img.clamp(0, 255).to(torch.uint8)


def patch_pool(seed: int, n: int, size: int, device, chunk: int = 1024) -> np.ndarray:
    """``n`` H&E-like uint8 patches (``_patch_chunks``) on the host."""
    out = np.empty((n, size, size, 3), np.uint8)
    for s, part in _patch_chunks(seed, n, size, device, chunk):
        out[s:s + len(part)] = part.cpu().numpy()
    return out


def feature_pool(cfg: dict, seed: int, n: int, device, mode: str = "tf32",
                 chunk: int = 128) -> np.ndarray:
    """``n`` stored patch features on the host, as users store them: the
    reference backbone's (n, feature_dim) f32 features (ResNet-50's pooled
    post-ReLU ones in ``sequoia-resnet50-vis``), under ``mode``, of ``n``
    H&E-like patches (``_patch_chunks``), with the backbone weights a run of
    ``seed`` draws.  The reference makes them; nothing comes from the
    program."""
    b = cfg["backbone"]
    kind = backbone_kind(cfg)
    backbone = backbone_weights(cfg, seed, device)
    out = np.empty((n, b["feature_dim"]), np.float32)
    with torch.no_grad():
        for s, part in _patch_chunks(seed, n, b["patch_size"], device, chunk):
            out[s:s + len(part)] = kind.reference(b, backbone, part, device, mode).cpu().numpy()
    del backbone
    return out


class Sample:
    """The served slides kept for the check: a reservoir, drawn from the
    seed, of ``full`` slides of the largest size and of ``other`` slides
    of the others, so the sample is uniform over what was served and holds
    the longest."""

    def __init__(self, seed: int, full: int, other: int, largest: int):
        self.r = rng(seed, 5)
        self.size = {True: full, False: other}
        self.seen = {True: 0, False: 0}
        self.kept = {True: [], False: []}
        self.largest = largest

    def offer(self, item: dict) -> None:
        big = item["n"] == self.largest
        self.seen[big] += 1
        kept, k = self.kept[big], self.size[big]
        if len(kept) < k:
            kept.append(item)
        elif k:
            j = int(self.r.integers(0, self.seen[big]))
            if j < k:
                kept[j] = item

    def items(self) -> list[dict]:
        return self.kept[True] + self.kept[False]


def capture(pred, last: dict) -> None:
    """Keep a reference to what the extractor and the clustering of the
    timed calls return (the predictor's methods are wrapped on this
    instance only; the calls themselves are unchanged)."""
    if pred.extractor is not None:
        features = pred.extractor.features

        def kept_features(x):
            last["features"] = features(x)
            return last["features"]
        pred.extractor.features = kept_features
    cluster = pred.cluster

    def kept_cluster(f):
        last["cf"] = cluster(f)
        return last["cf"]
    pred.cluster = kept_cluster


def reference_features(cfg: dict, backbone: dict, u8: np.ndarray, device,
                       mode: str = "float32", block: int = 32) -> torch.Tensor:
    """The reference backbone over host uint8 patches, in blocks."""
    b, kind = cfg["backbone"], backbone_kind(cfg)
    return torch.cat([kind.reference(b, backbone, u8[s:s + block], device, mode)
                      for s in range(0, len(u8), block)])


def reference_genes(cfg: dict, folds: list[dict], cf: torch.Tensor,
                    mode: str = "float32") -> torch.Tensor:
    """The fold ensemble's mean over (k, D) cluster features -> (G,)."""
    heads = cfg["vis"]["nheads"]
    return torch.stack([ref_vis.forward(p, cf[None].float(), heads, mode)[0]
                        for p in folds]).mean(0)


def feat_gap(port: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest gap of a row: ``|port - ref| / |ref|`` over rows."""
    port, ref = port.double(), ref.double()
    return float(((port - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)).max())


def genes_gap(port, ref: torch.Tensor) -> float:
    """Widest gap of a gene, as a share of the root mean square of the
    reference's genes."""
    ref = ref.double().flatten()
    port = torch.as_tensor(np.asarray(port), device=ref.device).double().flatten()
    return float((port - ref).abs().max() / ref.square().mean().sqrt().clamp(min=1e-30))


def bad_answer(genes, n_genes: int) -> bool:
    a = np.asarray(genes)
    return a.shape != (1, n_genes) or not np.isfinite(a).all()


def check_slides(cfg: dict, traffic: dict, seed: int, kept: list[dict], backbone,
                 folds: list[dict], device, *, pool=None, inputs=None) -> dict:
    """The readings of the kept slides.  ``feat_gap``: the backbone's
    features of a sample of each slide's patches against the reference's
    (where there is a backbone).  ``kmeans_misfit``: the cluster means
    against the partition of the features they were fitted to (the
    program's features, or the input features) that they define
    (``reference.kmeans.misfit``).  ``genes_gap``: the genes against the
    reference folds over the reference's own means of that partition, so a
    wrong clustering shows here too."""
    out = {"feat_gap": 0.0, "kmeans_misfit": 0.0, "genes_gap": 0.0}
    rows = traffic["check"].get("rows", 0)
    for i, item in enumerate(kept):
        lo, n = item["offset"], item["n"]
        if backbone is not None:
            pick = np.sort(rng(seed, 1000 + i).choice(n, size=min(rows, n), replace=False))
            ref = reference_features(cfg, backbone, pool[lo + pick], device)
            out["feat_gap"] = max(out["feat_gap"], feat_gap(item["features"][pick], ref))
            x = item["features"]
        else:
            x = torch.as_tensor(inputs[lo:lo + n], device=device)
        read = judge(cfg, folds, x, item["cf"], item["genes"])
        for k, v in read.items():
            out[k] = max(out[k], v)
    if backbone is None:
        del out["feat_gap"]
    return out


def judge(cfg: dict, folds: list[dict], x: torch.Tensor, cf: torch.Tensor, genes,
          mode: str = "float32") -> dict:
    """``kmeans_misfit`` of ``cf`` on ``x``, and ``genes_gap`` of ``genes``
    against the f32 reference folds over the means of the partition that
    ``cf`` defines (NaN, and so a failed reading, where ``cf`` is not
    finite)."""
    mis = ref_kmeans.misfit(x, cf)
    if not np.isfinite(mis):
        return {"kmeans_misfit": mis, "genes_gap": float("inf")}
    m, _, _ = ref_kmeans.partition_means(x, cf)
    m = torch.where(torch.isnan(m), torch.zeros_like(m), m).float()
    return {"kmeans_misfit": mis, "genes_gap": genes_gap(genes, reference_genes(cfg, folds, m))}


def slide_work(cfg: dict, n: int, n_iter: int, backbone: bool = True) -> dict:
    """(flops by dtype, bytes) of each layer of one slide of ``n`` patches
    (``backbone`` False: of ``n`` features, no backbone)."""
    b, k, v = cfg["backbone"], cfg["kmeans"], cfg["vis"]
    km = arith.kmeans_work(n, b["feature_dim"], k["n_clusters"], n_iter)
    fo = arith.vis_folds_work(v["folds"], v["num_clusters"], v["compute_dtype"],
                              **vis_shape(cfg))
    if not backbone:
        return {"kmeans": km, "folds": fo}
    return {"backbone": backbone_kind(cfg).work(b, n), "kmeans": km, "folds": fo}


def run(ctx: dict, from_patches: bool) -> dict:
    """One run of a serving cell: set-up, a closed loop of one client over
    the window, then the check.  ``from_patches``: slides of uint8 patches
    through ``predict_patches``; else slides of features through
    ``predict_features``."""
    import sys
    import time

    from benchmark import common
    from benchmark import trace as tr

    cfg, traffic, seed, dev = ctx["config"], ctx["traffic"], ctx["seed"], ctx["device"]
    sync = lambda: common.sync(torch, dev)  # noqa: E731
    backbone = backbone_weights(cfg, seed, dev) if from_patches else None
    folds = fold_weights(cfg, seed, dev)
    pred, on, why = build_predictor(cfg, backbone, folds, dev)
    print(f"kernels: {', '.join(on) or 'none'}" + (f"; K1 left out: {why}" if why else ""),
          file=sys.stderr)
    b = cfg["backbone"]
    if from_patches:
        pool = patch_pool(seed, traffic["pool"], b["patch_size"], dev)
        inputs = None
    else:
        pool = None
        inputs = feature_pool(cfg, seed, traffic["pool"], dev, traffic["pool_precision"])
    c = traffic["cycle"]
    sizes = sorted({n for pair in c["pairs"] for n in pair} | {c["full"]})
    last: dict = {}
    capture(pred, last)
    if ctx.get("fault"):
        ctx["fault"](pred)
    # warm-up: every size of the cycle through the calls the window makes
    if from_patches:
        pred.predict_patches(pool[:c["full"]])
        for n in sizes:
            pred.predict_features(last["features"][:n])
    else:
        for n in sizes:
            pred.predict_features(inputs[:n])
    sync()
    setup_s = time.perf_counter() - ctx["t_start"]

    record = {"spans": {}}
    traced = ctx["trace"]
    fit_calls = []
    if traced:
        from sequoia_tpu_torch.ops import kmeans as km

        fit = km.kmeans_fit

        def counted_fit(*a, **kw):
            out = fit(*a, **kw)
            fit_calls.append(int(out[3]))
            return out
        km.kmeans_fit = counted_fit
    prof = rf = done_prof = None
    n_traced = patches_traced = 0
    work_traced: dict = {}
    sample = Sample(seed, traffic["check"]["full"], traffic["check"]["other"], c["full"])
    sched = schedule(traffic, seed, traffic["pool"])
    n_genes = cfg["vis"]["num_outputs"]
    lat, attempted, failed, bad, patches = [], 0, 0, 0, 0
    lat_unprofiled = []  # the slides that ran with no profiler session open
    window = common.Window(ctx["seconds"])
    from sequoia_tpu_torch import _build

    if traced:
        prof, rf = _start_profile(dev)
    launches0 = dict(_build.LAUNCHES)
    window.open()
    group_end = False
    while not group_end or window.due():
        n, off, group_end = next(sched)
        attempted += 1
        x = pool[off:off + n] if from_patches else inputs[off:off + n]
        profiled = prof is not None
        t0 = time.perf_counter()
        try:
            if traced:
                if from_patches:
                    with tr.span(record, "backbone", sync):
                        f = pred.extractor.features(x)
                else:
                    f = x
                with tr.span(record, "kmeans", sync):
                    cf = pred.cluster(f)
                with tr.span(record, "folds", sync):
                    genes = pred.predict_cluster_features(cf)
            else:
                genes = pred.predict_patches(x) if from_patches else pred.predict_features(x)
        except Exception as e:  # a failed slide is counted, and the run goes on
            print(f"slide {attempted - 1} ({n} patches) failed: {e!r}", file=sys.stderr)
            failed += 1
            continue
        lat.append(time.perf_counter() - t0)
        if not profiled:
            lat_unprofiled.append(lat[-1])
        patches += n
        if bad_answer(genes, n_genes):
            bad += 1
        sample.offer({"n": n, "offset": off, "genes": genes, "cf": last["cf"],
                      "features": last.get("features")})
        if prof is not None:
            n_traced += 1
            patches_traced += n
            for k, (fl, by) in slide_work(cfg, n, fit_calls[-1], from_patches).items():
                acc = work_traced.setdefault(k, [{}, 0.0])
                for dt, v in fl.items():
                    acc[0][dt] = acc[0].get(dt, 0.0) + v
                acc[1] += by
            if n_traced >= traffic["trace_slides"]:
                done_prof = _stop_profile(prof, rf)
                prof = None
    window_s = window.close()
    launches = common.launches_per(_build.LAUNCHES, 0, launches0, len(lat))
    if prof is not None:
        done_prof = _stop_profile(prof, rf)
    if traced:
        km.kmeans_fit = fit
        record["trace"] = tr.reduce(tr.events_of(done_prof))
    device = common.device_info(torch, dev, ctx["chips"])
    done = len(lat)
    record["items"] = {"slides": done, "patches": patches, "slides_traced": n_traced,
                       "patches_traced": patches_traced}
    record["work"] = {k: (v[0], v[1]) for k, v in work_traced.items()}
    record["slide_s"] = lat_unprofiled
    kept = sample.items()
    del pred, last
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = check_slides(cfg, traffic, seed, kept, backbone, folds, dev, pool=pool,
                            inputs=inputs)
    readings["bad_answers"] = bad
    e2e = {"slides_per_hour": 3600.0 * done / window_s if window_s > 0 else None,
           "setup_s": setup_s}
    return {"e2e": e2e, "record": record, "readings": readings, "attempted": attempted,
            "failed": failed + bad, "device": device,
            "notes": {"window_s": window_s, "slides": done, "checked": len(kept),
                      "slide_p95_s": common.quantile(lat, 0.95) if lat else None,
                      "launches_per_slide": launches,
                      "lloyd_steps": fit_calls}}


def _start_profile(dev):
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace as tr

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    rf = record_function(tr.WINDOW)
    rf.__enter__()
    return prof, rf


def _stop_profile(prof, rf):
    """End the traced window; the events stay in memory until reduced."""
    rf.__exit__(None, None, None)
    prof.stop()
    return prof
