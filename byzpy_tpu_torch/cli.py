"""The ``byzpy-tpu-torch`` command line.

Counterpart of ``byzpy_tpu/cli.py``: ``version``, ``doctor`` (an
environment report: torch and its CUDA, the card's name and power limit,
``nvcc``, a build of every CUDA source, the shm store), ``list
aggregators|attacks|pre-aggregators`` by subclass discovery, ``bench`` (the
four hot aggregators timed on the card) and ``study`` (one
accuracy-under-attack cell pair on the bundled digits, or on synthetic
blobs of their shape where scikit-learn is missing). The reference's ``lint``
runs its static-analysis package, which is not ported (ROADMAP A.8), so
the parser has no ``lint``.

``version`` imports no torch: this module imports it only inside the
commands that need it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Type

from .version import __version__

#: mirrors utils.robust_study.STUDY_AGGREGATORS / STUDY_ATTACKS, kept literal
#: so that ``version`` never imports torch (a test pins the sync)
STUDY_AGGREGATORS = ("mean", "median", "trimmed_mean", "multi_krum", "geometric_median",
                     "nnm_trimmed_mean")
STUDY_ATTACKS = ("none", "sign_flip", "empire", "little", "gaussian", "mimic")


def _subclasses_of(base: Type) -> List[Type]:
    """Every concrete subclass of ``base``, sorted by name (the package's
    ``__init__`` imports every built-in, so walking the subclass tree is
    the reference's discovery by package scan)."""
    seen: Dict[str, Type] = {}
    stack = list(base.__subclasses__())
    while stack:
        cls = stack.pop()
        stack.extend(cls.__subclasses__())
        if not getattr(cls, "__abstractmethods__", None):
            seen[cls.__name__] = cls
    return [seen[k] for k in sorted(seen)]


def _collect(kind: str) -> List[Type]:
    if kind == "aggregators":
        import byzpy_tpu_torch.aggregators  # noqa: F401 - registers the subclasses
        from byzpy_tpu_torch.aggregators.base import Aggregator as base
    elif kind == "attacks":
        import byzpy_tpu_torch.attacks  # noqa: F401
        from byzpy_tpu_torch.attacks.base import Attack as base
    elif kind == "pre-aggregators":
        import byzpy_tpu_torch.pre_aggregators  # noqa: F401
        from byzpy_tpu_torch.pre_aggregators.base import PreAggregator as base
    else:  # pragma: no cover - argparse's choices guard this
        raise ValueError(kind)
    return _subclasses_of(base)


def cmd_version(_args: argparse.Namespace) -> int:
    """``version``: print the package version."""
    print(__version__)
    return 0


def _probe_timeout(default: float) -> float:
    try:
        return float(os.environ.get("BYZPY_TPU_TORCH_DOCTOR_TIMEOUT", default))
    except ValueError:
        return default  # a malformed override (e.g. "20s") keeps the default


def _with_timeout(fn: Callable[[], Any], timeout_s: float, what: str) -> Any:
    """``fn()`` bounded by ``timeout_s`` seconds: a CUDA driver that hangs while
    it initializes the card must not hang a diagnostics command. The probe
    runs on a daemon thread, which dies with the process if it never
    returns. ``BYZPY_TPU_TORCH_DOCTOR_TIMEOUT`` overrides the limit."""
    result: list = []

    def probe() -> None:
        try:
            result.append(("ok", fn()))
        except Exception as exc:  # noqa: BLE001 - forwarded to the caller
            result.append(("err", exc))

    t = threading.Thread(target=probe, name=f"doctor-{what}", daemon=True)
    t.start()
    t.join(timeout_s)
    if not result:
        raise TimeoutError(f"{what} did not answer within {timeout_s:g} s")
    kind, value = result[0]
    if kind == "err":
        raise value
    return value


def _cuda_devices() -> List[Dict[str, Any]]:
    import torch

    if not torch.cuda.is_available():
        return []
    return [{"index": i, "name": torch.cuda.get_device_name(i),
             "capability": list(torch.cuda.get_device_capability(i))}
            for i in range(torch.cuda.device_count())]


def _nvidia_smi() -> List[str]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def doctor_report(*, build: bool = True) -> Dict[str, Any]:
    """The environment probe. Each part reports an error of its own instead
    of failing the report. ``build=False`` skips the kernels' build."""
    report: Dict[str, Any] = {"version": __version__, "python": sys.version.split()[0]}
    try:
        import torch

        report["torch"] = {"ok": True, "version": torch.__version__, "cuda": torch.version.cuda}
    except Exception as exc:  # noqa: BLE001 - reported
        report["torch"] = {"ok": False, "error": repr(exc)}
        return report
    timeout = _probe_timeout(20.0)
    try:
        devices = _with_timeout(_cuda_devices, timeout, "the CUDA device probe")
        report["devices"] = devices
        report["device_count"] = len(devices)
    except Exception as exc:  # noqa: BLE001 - reported
        report["devices_error"] = repr(exc)
    try:
        report["nvidia_smi"] = _nvidia_smi()
    except (OSError, subprocess.SubprocessError) as exc:
        report["nvidia_smi_error"] = repr(exc)
    from .ops import _build

    nvcc = _build.find_nvcc()
    report["nvcc"] = {"path": nvcc}
    if nvcc is not None:
        try:
            out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60,
                                 check=True)
            report["nvcc"]["version"] = out.stdout.strip().splitlines()[-1]
        except (OSError, subprocess.SubprocessError) as exc:
            report["nvcc"]["error"] = repr(exc)
    if build:
        if nvcc is None:
            report["kernels"] = {"ok": False, "error": "nvcc not found: the CUDA sources cannot "
                                 "be built on this machine"}
        else:
            try:
                t0 = time.perf_counter()
                paths = _build.build_all()
                report["kernels"] = {"ok": True, "sources": sorted(paths),
                                     "seconds": time.perf_counter() - t0}
            except RuntimeError as exc:
                report["kernels"] = {"ok": False, "error": str(exc)}
    try:
        from .engine.storage import native_store

        report["native_shm_store"] = {"ok": native_store.available()}
    except Exception as exc:  # noqa: BLE001 - an optional native extension
        report["native_shm_store"] = {"ok": False, "error": repr(exc)}
    return report


def cmd_doctor(args: argparse.Namespace) -> int:
    """``doctor``: print the environment probe (text or json)."""
    report = doctor_report(build=not args.no_build)
    if args.format == "json":
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for key, value in sorted(report.items()):
            print(f"{key}: {value}")
    return 0


def cmd_list(args: argparse.Namespace) -> int:
    """``list``: the registered aggregators, attacks or pre-aggregators."""
    for cls in _collect(args.kind):
        name = getattr(cls, "name", None) or cls.__name__
        print(f"{cls.__name__}\t({name})")
    return 0


def _ms_per_call(fn: Callable, x, *, warmup: int, repeat: int) -> float:
    """Milliseconds a call: CUDA events around ``repeat`` calls on the
    card, the host clock on the CPU."""
    import torch

    for _ in range(warmup):
        fn(x)
    if x.is_cuda:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeat):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / repeat
    t0 = time.perf_counter()
    for _ in range(repeat):
        fn(x)
    return (time.perf_counter() - t0) * 1e3 / repeat


def bench_report(*, n: int = 16, d: int = 65_536, repeat: int = 10,
                 device: Optional[str] = None) -> Dict[str, Any]:
    """A quick micro-benchmark of the hot aggregators, one row an op in
    milliseconds a call: the sanity companion to ``doctor`` (does this card
    give the expected order of magnitude?). On the card by default;
    ``device="cpu"`` only when asked. The measured grid lives in
    ``chip_smoke.py``."""
    import functools

    import torch

    from .ops import robust
    from .utils.device import resolve_device

    try:
        dev = _with_timeout(lambda: resolve_device(device), _probe_timeout(20.0),
                            "the device probe")
    except Exception as exc:  # noqa: BLE001 - reported, the bench has no device
        return {"error": f"device probe failed: {type(exc).__name__}: {exc}"}
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn((n, d), generator=g, dtype=torch.float32).to(dev)
    rows: Dict[str, Any] = {
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "shape": [n, d],
        "repeat": repeat,
        "clock": "cuda_events" if dev.type == "cuda" else "host",
    }
    f = max(1, n // 8)
    ops = {
        "coordinate_median": robust.coordinate_median,
        "trimmed_mean": functools.partial(robust.trimmed_mean, f=f),
        "multi_krum": functools.partial(robust.multi_krum, f=f, q=max(1, n // 4)),
        "geometric_median": functools.partial(robust.geometric_median, max_iter=32),
    }
    for name, fn in ops.items():
        try:
            rows[name] = {"ms": _ms_per_call(fn, x, warmup=2, repeat=repeat)}
        except Exception as exc:  # noqa: BLE001 - reported, the other ops still run
            rows[name] = {"error": f"{type(exc).__name__}: {exc}"}
    return rows


def cmd_bench(args: argparse.Namespace) -> int:
    """``bench``: print the micro-benchmark as JSON."""
    report = bench_report(n=args.nodes, d=args.dim, repeat=args.repeat, device=args.device)
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0


def _synthetic_digits(seed: int, device: Optional[str]):
    """``(x_train, y_train, x_test, y_test)`` shaped as the digits set (8 x
    8 x 1 images, 10 classes, 1,797 samples, a quarter held out) from
    ``models.data.synthetic_classification``: for hosts without
    scikit-learn."""
    from .models.data import synthetic_classification
    from .utils.device import resolve_device

    x, y = synthetic_classification(n_samples=1797, input_shape=(8, 8, 1), seed=seed,
                                    device=resolve_device(device))
    n_test = round(0.25 * x.shape[0])
    return x[n_test:], y[n_test:], x[:n_test], y[:n_test]


def cmd_study(args: argparse.Namespace) -> int:
    """``study``: one accuracy-under-attack cell pair on real data, the mean
    beside a robust aggregator."""
    from .utils.robust_study import StudyConfig, results_table, run_study

    cfg = StudyConfig(rounds=args.rounds, eval_every=max(1, args.rounds // 3))
    data = None
    if args.data == "synthetic":
        data = _synthetic_digits(cfg.seed, args.device)
    results = run_study(
        aggregators=tuple(dict.fromkeys(("mean", args.aggregator))),
        attacks=(args.attack,),
        cfg=cfg,
        data=data,
        verbose=True,
        device=args.device,
    )
    print()
    print(results_table(results))
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The ``byzpy-tpu-torch`` parser, one subcommand a ``cmd_*``."""
    parser = argparse.ArgumentParser(
        prog="byzpy-tpu-torch",
        description="Byzantine-robust distributed learning on NVIDIA GPUs (PyTorch/CUDA)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_version = sub.add_parser("version", help="print the package version")
    p_version.set_defaults(fn=cmd_version)

    p_doctor = sub.add_parser("doctor", help="report the torch/CUDA environment")
    p_doctor.add_argument("--format", choices=("text", "json"), default="text")
    p_doctor.add_argument("--no-build", action="store_true",
                          help="skip the build of the CUDA sources")
    p_doctor.set_defaults(fn=cmd_doctor)

    p_list = sub.add_parser("list", help="list available operator classes")
    p_list.add_argument("kind", choices=("aggregators", "attacks", "pre-aggregators"))
    p_list.set_defaults(fn=cmd_list)

    p_bench = sub.add_parser("bench", help="quick micro-benchmark of the hot aggregators")
    p_bench.add_argument("--nodes", type=int, default=16)
    p_bench.add_argument("--dim", type=int, default=65_536)
    p_bench.add_argument("--repeat", type=int, default=10)
    p_bench.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    p_bench.set_defaults(fn=cmd_bench)

    p_study = sub.add_parser(
        "study", help="robust-learning demo: the mean vs a robust aggregator under attack")
    p_study.add_argument("--aggregator", default="trimmed_mean", choices=STUDY_AGGREGATORS)
    p_study.add_argument("--attack", default="sign_flip", choices=STUDY_ATTACKS)
    p_study.add_argument("--rounds", type=int, default=120)
    p_study.add_argument("--data", choices=("digits", "synthetic"), default="digits",
                         help="the bundled digits (needs scikit-learn) or synthetic blobs of "
                              "their shape")
    p_study.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    p_study.set_defaults(fn=cmd_study)

    return parser


def main(argv: Optional[List[str]] = None) -> int:
    """Console entry point (``byzpy-tpu-torch`` in pyproject's scripts)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
