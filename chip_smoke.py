"""Smoke run of the demultiplexing engine on the GPU, through its public entry points.

    python chip_smoke.py                # phases 1-5 on one card
    python chip_smoke.py --four-cards   # phase 6 only: the sharded engine on four cards

Phases:

1. environment: card name and power limit, jax/jaxlib/CUDA plug-in
   versions, device kind, pandas/pyarrow, the native libraries (built here;
   a missing one fails the run instead of falling back to Python);
2. the CLI (``demux`` with EM refinement) on ``examples/example_data``,
   from the BAM scan to the written posteriors;
3. the engine at deployment size through the public API: the at-scale
   workload of ``benchmarks/at_scale_quality.py`` (32 donors = 528
   pseudogenotypes, 65,536 barcodes, 65,536 SNPs, 64 calls per barcode,
   seed 0), checked against the accuracy recorded in QUALITY.json;
4. the compiled E-step kernel against the exact XLA path (full shape) and
   the float64 numpy oracle (2,048 barcodes), the XLA M-step against its
   oracle, and the ``gpu``-marked tests;
5. warm timings at the bench and preprint shapes (informative only).

Any failed check raises, so the process exits non-zero; only when every
phase passed is the last line ``{"ok": true, "device": {...}}``. Without a
GPU, or without the rest of the repository next to it, it fails at once.
"""
import importlib
import importlib.metadata
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
CARD = "unknown card"  # nvidia-smi's "name, power limit", set in phase 1

# deployment-size workload (benchmarks/at_scale_quality.py, QUALITY.json at_scale)
AT_SCALE = dict(n_barcodes=65_536, n_donors=32, n_snps=65_536, calls_per_barcode=64)
# timing shapes: bench.py's, and the preprint's (131,072 barcodes, ~800k variants, ~22M calls)
TIMING_SHAPES = {
    "bench": dict(n_barcodes=65_536, n_donors=32, n_snps=65_536, calls_per_barcode=64),
    "preprint": dict(n_barcodes=131_072, n_donors=32, n_snps=400_000, calls_per_barcode=168),
}
ORACLE_BARCODES = 2_048
LOGIT_RTOL, LOGIT_ATOL, POSTERIOR_ATOL = 1e-5, 1e-4, 1e-4
# QUALITY.json at_scale recorded 0.9998, 0.9924 and an EM loss of 0.3982
QUALITY_FLOOR = dict(singlet_accuracy=0.997, doublet_exact_accuracy=0.990)
EM_LOSS_CEILING = 0.40


def log(message: str) -> None:
    print(message, flush=True)


def check(ok, message: str) -> None:
    if not ok:
        raise AssertionError(message)


def load_repo():
    """Put the repository on the path; fail if only this script is here."""
    if not (REPO / "demuxalot_tpu" / "__init__.py").exists():
        raise SystemExit(f"chip_smoke.py: no demuxalot_tpu package next to {__file__}")
    for path in (REPO, REPO / "benchmarks", REPO / "tests"):
        sys.path.insert(0, str(path))


def require_gpu():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {jax.default_backend()!r}")
    return jax.devices()


# --------------------------------------------------------------------------
def phase_environment(n_cards: int) -> None:
    global CARD
    import jax
    import jaxlib

    rows = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    CARD = rows[0]
    for row in rows:
        log(row)
    check(len(jax.devices()) >= n_cards, f"JAX sees {len(jax.devices())} devices, need {n_cards}")
    plugins = []
    for name in ("jax-cuda12-plugin", "jax-cuda13-plugin"):
        try:
            plugins.append(f"{name} {importlib.metadata.version(name)}")
        except importlib.metadata.PackageNotFoundError:
            pass
    log(f"[env] jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"{', '.join(plugins) or 'no CUDA plug-in package'}")
    log(f"[env] device_kind {jax.devices()[0].device_kind!r}, {len(jax.devices())} devices")
    for module in ("pandas", "pyarrow"):
        try:
            log(f"[env] {module} {importlib.import_module(module).__version__} imports")
        except ImportError as error:
            log(f"[env] {module} does not import: {error}")
    from demuxalot_tpu import native

    for loader in (native.load_library, native.load_host_library):
        log(f"[env] native {loader.__name__}: {loader()._name}")


# --------------------------------------------------------------------------
def phase_cli() -> None:
    import numpy as np
    import pandas as pd

    from demuxalot_tpu import cli

    data = REPO / "examples" / "example_data"
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        rc = cli.main([
            "demux", "--bam", str(data / "test_bamfile.bam"),
            "--barcodes", str(data / "test_barcodes.csv"),
            "--vcf", str(data / "test_genotypes.vcf"),
            "--output-dir", out, "--jobs", "2",
        ])
        seconds = time.perf_counter() - t0
        check(rc == 0, f"cli demux returned {rc}")
        for name in ("posteriors.csv", "assignments.csv", "learnt_betas.parquet"):
            check((Path(out) / name).exists(), f"cli demux wrote no {name}")
        probs = pd.read_csv(Path(out) / "posteriors.csv", index_col=0)
        n_barcodes = sum(1 for line in open(data / "test_barcodes.csv") if line.strip())
        check(probs.shape[0] == n_barcodes, f"{probs.shape[0]} posterior rows, {n_barcodes} barcodes")
        check(np.isfinite(probs.values).all(), "non-finite posteriors")
        row_error = float(np.abs(probs.values.sum(axis=1) - 1).max())
        check(row_error < 1e-5, f"posterior rows sum to 1 within {row_error}")
    log(f"[cli] demux with refinement: {probs.shape[0]} barcodes x {probs.shape[1]} columns, "
        f"max |row sum - 1| {row_error:.2e}, {seconds:.2f} s (first run, compiles included)")


# --------------------------------------------------------------------------
def phase_engine() -> None:
    import numpy as np

    from _metrics import doublet_metrics, singlet_loss
    from demuxalot_tpu import BarcodeHandler, Demultiplexer
    from synth_calls import synthesize_compressed_calls

    n_barcodes = AT_SCALE["n_barcodes"]
    genotypes, calls, truth, _names = synthesize_compressed_calls(seed=0, **AT_SCALE)
    handler = BarcodeHandler([f"BC{b:06}" for b in range(n_barcodes)])
    t0 = time.perf_counter()
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    log(f"[engine] pack_dataset: {len(packed.calls_v.vid)} collapsed calls, "
        f"{time.perf_counter() - t0:.2f} s on the host")

    def rows_ok(probs, label):
        values = probs.values
        check(np.isfinite(values).all(), f"{label}: non-finite posteriors")
        error = float(np.abs(values.sum(axis=1) - 1).max())
        check(error <= 1e-5, f"{label}: rows sum to 1 within {error}")
        return error

    t0 = time.perf_counter()
    logits, probs = Demultiplexer.predict_posteriors(packed, genotypes, handler, doublet_prior=0.35)
    t_predict = time.perf_counter() - t0
    check(probs.shape == (n_barcodes, 528), f"posterior frame {probs.shape}")
    error = rows_ok(probs, "predict_posteriors")
    metrics = doublet_metrics(probs, truth)
    log(f"[engine] predict_posteriors(doublet_prior=0.35): {metrics}, "
        f"max |row sum - 1| {error:.2e}, {t_predict:.2f} s ({CARD})")
    for key, floor in QUALITY_FLOOR.items():
        check(metrics[key] >= floor, f"{key} {metrics[key]} < {floor}")

    degraded = genotypes.clone()
    snp_ids = degraded.get_snp_ids_for_variants()
    erased = np.random.RandomState(1234).random(snp_ids.max() + 1) < 0.9
    degraded.variant_betas[erased[snp_ids], :] = 0
    t0 = time.perf_counter()
    _learnt, probs_em = Demultiplexer.learn_genotypes(packed, degraded, handler, n_iterations=5)
    t_learn = time.perf_counter() - t0
    error = rows_ok(probs_em, "learn_genotypes")
    loss = singlet_loss(probs_em, truth)
    log(f"[engine] learn_genotypes(5 iterations, 90% degraded): loss {loss:.4f}, "
        f"singlet accuracy {doublet_metrics(probs_em, truth)['singlet_accuracy']}, "
        f"max |row sum - 1| {error:.2e}, {t_learn:.2f} s ({CARD})")
    check(loss <= EM_LOSS_CEILING, f"EM loss {loss} > {EM_LOSS_CEILING}")

    t0 = time.perf_counter()
    compact = Demultiplexer.predict_posteriors_compact(
        packed, genotypes, handler, doublet_prior=0.35, k=4
    )
    t_compact = time.perf_counter() - t0
    check(np.isfinite(compact.top_logits).all() and np.isfinite(compact.logsumexp).all(),
          "compact: non-finite values")
    full_argmax = logits.values.argmax(axis=1)
    check(np.array_equal(compact.assignment, full_argmax), "compact argmax != full argmax")
    check(np.allclose(compact.top_probs[:, 0], probs.values.max(axis=1), atol=1e-5),
          "compact top posterior != full frame")
    log(f"[engine] predict_posteriors_compact(k=4): argmax equals the full frame's on all "
        f"{n_barcodes} barcodes, {compact.bytes_moved} bytes read back, {t_compact:.2f} s ({CARD})")


# --------------------------------------------------------------------------
def device_workload(shape, doublet_prior=0.35):
    """Kernel-level arrays of the bench generator (same model as synth_calls)."""
    import jax.numpy as jnp
    import numpy as np

    from demuxalot_tpu.ops import estep_kernel as K
    from demuxalot_tpu.ops import likelihood as L
    from demuxalot_tpu.sim import synthesize_device_workload

    betas, v2s, vid, cb, q, _truth = synthesize_device_workload(seed=0, **shape)
    n_donors = shape["n_donors"]
    mixing, _ = L.pseudogenotype_mixing([f"D{i:02}" for i in range(n_donors)], doublet_prior)
    penalties = L.doublet_penalties(n_donors, doublet_prior)
    runs = K.CallRuns.build(cb, vid, q, shape["n_barcodes"])
    vorder = np.argsort(vid, kind="stable")
    w = dict(
        host=dict(betas=betas, vid=vid, cb=cb, q=q, mixing=mixing, penalties=penalties),
        betas=jnp.asarray(betas), v2s=jnp.asarray(v2s), mixing=jnp.asarray(mixing),
        penalties=jnp.asarray(penalties), vid=jnp.asarray(vid), cb=jnp.asarray(cb),
        q=jnp.asarray(q), runs=[jnp.asarray(x) for x in (runs.offsets, runs.vid, runs.q)],
        vid_v=jnp.asarray(vid[vorder]), cb_v=jnp.asarray(cb[vorder]), q_v=jnp.asarray(q[vorder]),
        doublets=K.check_mixing(mixing), n_variants=betas.shape[0], **shape,
    )
    return w


def step_functions(w):
    """(genotype probs, kernel E-step, XLA E-step, M-step) closures over a workload."""
    import jax.numpy as jnp

    from demuxalot_tpu.ops import estep_kernel as K
    from demuxalot_tpu.ops import likelihood as L

    def genotype_prob(addition):
        return L.probs_from_betas(w["betas"] + addition, w["v2s"], w["n_snps"], 0.01, max_per_snp=2)

    def estep_kernel(addition):
        return K.estep_logits(genotype_prob(addition), w["penalties"], *w["runs"],
                              n_barcodes=w["n_barcodes"], doublets=w["doublets"])

    def estep_xla(addition):
        return L.barcode_logits(genotype_prob(addition), w["mixing"], w["penalties"],
                                w["vid"], w["cb"], w["q"], w["n_barcodes"])

    def mstep(probs):
        return L.genotype_addition_from_posteriors(
            probs, w["vid_v"], w["cb_v"], w["q_v"], w["n_variants"], w["n_donors"], 2.0)

    return genotype_prob, estep_kernel, estep_xla, mstep, jnp.zeros_like(w["betas"])


def phase_reference() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from oracle import oracle_barcode_logits, oracle_mstep

    w = device_workload(TIMING_SHAPES["bench"])
    genotype_prob, estep_kernel, estep_xla, mstep, zero = step_functions(w)
    got = jax.jit(estep_kernel)(zero)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(estep_xla)(zero)
    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape == (w["n_barcodes"], 528), f"logits {got.shape} vs {want.shape}")
    check(np.isfinite(got).all(), "kernel logits not finite")
    diff = np.abs(got - want)
    posterior_diff = np.abs(np.asarray(jax.nn.softmax(got, axis=-1) - jax.nn.softmax(want, axis=-1))).max()
    log(f"[reference] kernel vs XLA (highest), {got.shape}: max abs {diff.max():.3e}, "
        f"max rel {(diff / np.maximum(np.abs(want), 1e-30)).max():.3e}, posteriors max abs {posterior_diff:.3e}")
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    check(posterior_diff <= POSTERIOR_ATOL, f"posteriors differ by {posterior_diff}")

    # float64 oracle on the first barcodes (calls are sorted by barcode)
    host = w["host"]
    n_block = int(np.searchsorted(host["cb"], ORACLE_BARCODES))
    gp = np.asarray(genotype_prob(zero))
    names = [f"D{i:02}" for i in range(w["n_donors"])]
    sl = slice(0, n_block)
    oracle, _ = oracle_barcode_logits(names, gp, host["vid"][sl], host["cb"][sl], host["q"][sl],
                                      ORACLE_BARCODES, 0.35)
    block = got[:ORACLE_BARCODES]
    posterior_diff = np.abs(np.asarray(jax.nn.softmax(block, axis=-1))
                            - np.asarray(jax.nn.softmax(jnp.asarray(oracle), axis=-1))).max()
    log(f"[reference] kernel vs float64 oracle, {ORACLE_BARCODES} barcodes ({n_block} calls): "
        f"max abs {np.abs(block - oracle).max():.3e}, posteriors max abs {posterior_diff:.3e}")
    np.testing.assert_allclose(block, oracle, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    check(posterior_diff <= POSTERIOR_ATOL, f"posteriors differ by {posterior_diff}")

    # XLA M-step against its oracle on the same block
    post = np.asarray(jax.nn.softmax(jnp.asarray(block), axis=-1))
    vid_b, cb_b, q_b = host["vid"][sl], host["cb"][sl], host["q"][sl]
    order = np.argsort(vid_b, kind="stable")
    from demuxalot_tpu.ops import likelihood as L

    addition = np.asarray(jax.jit(
        lambda p: L.genotype_addition_from_posteriors(
            p, jnp.asarray(vid_b[order]), jnp.asarray(cb_b[order]), jnp.asarray(q_b[order]),
            w["n_variants"], w["n_donors"], 2.0)
    )(jnp.asarray(post)))
    oracle_add = oracle_mstep(post, vid_b, cb_b, q_b, w["n_variants"], w["n_donors"], 2.0)
    log(f"[reference] XLA M-step vs oracle, {ORACLE_BARCODES} barcodes: "
        f"max abs {np.abs(addition - oracle_add).max():.3e}")
    np.testing.assert_allclose(addition, oracle_add, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)

    run_gpu_tests()


def run_gpu_tests() -> None:
    """The ``gpu``-marked tests, in this process (one process per card)."""
    import pytest

    class Outcomes:
        def __init__(self):
            self.counts = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1

    outcomes = Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:randomly",
                      str(REPO / "tests" / "test_estep_kernel.py")], plugins=[outcomes])
    log(f"[reference] gpu-marked tests: {outcomes.counts}, exit {int(rc)}")
    check(int(rc) == 0 and outcomes.counts.get("passed", 0) >= 1
          and not outcomes.counts.get("skipped") and not outcomes.counts.get("failed"),
          "gpu-marked tests did not all pass")


# --------------------------------------------------------------------------
def warm(fn, *args, iters=5):
    """(compile+first call s, min s, median s), each call ended by block_until_ready."""
    import jax
    import numpy as np

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return first, min(samples), float(np.median(samples))


def memory(compiled) -> str:
    analysis = compiled.memory_analysis()
    if analysis is None:
        return "memory_analysis unavailable"
    return (f"args {analysis.argument_size_in_bytes} B, out {analysis.output_size_in_bytes} B, "
            f"temp {analysis.temp_size_in_bytes} B")


def phase_timings() -> None:
    import jax
    import numpy as np

    device = jax.devices()[0]
    log(f"[timing] compile cache: {jax.config.jax_compilation_cache_dir}")
    for label, shape in TIMING_SHAPES.items():
        w = device_workload(shape)
        _gp, estep_kernel, estep_xla, mstep, zero = step_functions(w)
        log(f"[timing] {label}: {shape['n_barcodes']} barcodes, {w['n_variants']} variants, "
            f"{int(w['vid'].shape[0])} calls, 528 pseudogenotypes ({CARD})")
        fns = {
            "estep_kernel": (jax.jit(estep_kernel), zero),
            "estep_xla": (jax.jit(estep_xla), zero),
            "em_iteration_kernel": (jax.jit(lambda a: mstep(jax.nn.softmax(estep_kernel(a), axis=-1))), zero),
            "em_iteration_xla": (jax.jit(lambda a: mstep(jax.nn.softmax(estep_xla(a), axis=-1))), zero),
        }
        probs = jax.nn.softmax(fns["estep_kernel"][0](zero), axis=-1)
        fns["mstep_xla"] = (jax.jit(mstep), probs)
        for name, (fn, arg) in fns.items():
            t0 = time.perf_counter()
            compiled = fn.lower(arg).compile()
            compile_s = time.perf_counter() - t0
            first, best, median = warm(compiled, arg)
            log(f"[timing] {label} {name}: min {best * 1e3:.3f} ms, median {median * 1e3:.3f} ms, "
                f"compile {compile_s:.2f} s, first call {first * 1e3:.3f} ms, "
                f"{memory(compiled)} ({CARD})")
        # device -> host rate of the posterior frame (the readback every
        # predict_posteriors pays): a fresh device copy, read back once
        frame = jax.block_until_ready(probs + 0.0)
        t0 = time.perf_counter()
        host = np.asarray(frame)
        seconds = time.perf_counter() - t0
        log(f"[timing] {label} posterior frame device->host: {host.nbytes} B in {seconds * 1e3:.3f} ms "
            f"= {host.nbytes / seconds / 1e9:.2f} GB/s ({CARD})")
        stats = device.memory_stats() or {}
        log(f"[timing] {label} peak_bytes_in_use {stats.get('peak_bytes_in_use')} ({CARD})")
        del w, fns, probs, frame, host


# --------------------------------------------------------------------------
def bytes_in_use(device) -> int:
    return device.memory_stats()["bytes_in_use"]


def phase_four_cards() -> None:
    """Sharded engine on a 4-device mesh against the single-device engine."""
    import jax
    import numpy as np

    from _metrics import doublet_metrics
    from demuxalot_tpu import BarcodeHandler, Demultiplexer
    from demuxalot_tpu.parallel import ShardedDemultiplexer, make_mesh
    from synth_calls import synthesize_compressed_calls

    devices = jax.devices()[:4]
    check(len(devices) == 4, f"--four-cards needs 4 devices, JAX sees {len(jax.devices())}")
    n_barcodes = AT_SCALE["n_barcodes"]
    genotypes, calls, truth, _names = synthesize_compressed_calls(seed=0, **AT_SCALE)
    handler = BarcodeHandler([f"BC{b:06}" for b in range(n_barcodes)])
    packed = Demultiplexer.pack_dataset(calls, genotypes)
    sharded = ShardedDemultiplexer(make_mesh(devices))

    before = [bytes_in_use(d) for d in devices]
    t0 = time.perf_counter()
    learnt_s, em_s = sharded.learn_genotypes(packed, genotypes, handler, n_iterations=3)
    t_learn = time.perf_counter() - t0
    after = [bytes_in_use(d) for d in devices]
    log(f"[four-cards] bytes_in_use per device after placement: {after} (before {before})")
    check(all(a > b for a, b in zip(after, before)), "a card holds no shard")
    t0 = time.perf_counter()
    logits_s, probs_s = sharded.predict_posteriors(packed, learnt_s, handler, doublet_prior=0.35)
    t_predict = time.perf_counter() - t0

    learnt_1, em_1 = Demultiplexer.learn_genotypes(packed, genotypes, handler, n_iterations=3)
    logits_1, probs_1 = Demultiplexer.predict_posteriors(packed, learnt_1, handler, doublet_prior=0.35)
    logit_diff = np.abs(logits_s.values - logits_1.values)
    posterior_diff = float(np.abs(probs_s.values - probs_1.values).max())
    same = float((logits_s.values.argmax(axis=1) == logits_1.values.argmax(axis=1)).mean())
    beta_diff = np.abs(learnt_s.get_betas() - learnt_1.get_betas())
    log(f"[four-cards] sharded vs single device: logits max abs {logit_diff.max():.3e}, "
        f"posteriors max abs {posterior_diff:.3e}, EM posteriors max abs "
        f"{np.abs(em_s.values - em_1.values).max():.3e}, learnt betas max abs {beta_diff.max():.3e}, "
        f"same argmax on {same:.6f} of barcodes")
    log(f"[four-cards] sharded learn (3 iterations) {t_learn:.2f} s, predict {t_predict:.2f} s, "
        f"accuracy {doublet_metrics(probs_s, truth)} ({CARD})")
    np.testing.assert_allclose(logits_s.values, logits_1.values, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    check(posterior_diff <= POSTERIOR_ATOL, f"posteriors differ by {posterior_diff}")
    np.testing.assert_allclose(learnt_s.get_betas(), learnt_1.get_betas(), rtol=1e-4, atol=1e-2)
    check(same == 1.0, "assignments differ")


# --------------------------------------------------------------------------
def main(argv) -> None:
    four_cards = "--four-cards" in argv
    load_repo()
    devices = require_gpu()
    phases = [("environment", lambda: phase_environment(4 if four_cards else 1))]
    if four_cards:
        phases.append(("four cards", phase_four_cards))
    else:
        phases += [("cli", phase_cli), ("engine", phase_engine),
                   ("reference", phase_reference), ("timings", phase_timings)]
    for name, phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"[phase] {name} passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind, "count": len(devices),
    }}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
