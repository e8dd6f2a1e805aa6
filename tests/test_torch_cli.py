"""The port's command line and the accuracy-under-attack study on the CPU.

The JAX package's ``tests/test_cli_utils_configs.py`` CLI cases and
``tests/test_robust_learning.py`` contracts on the port: ``version``
without torch, ``doctor``'s JSON and its bounded probe, ``list`` against
the JAX package's class names, ``bench --device cpu``, ``study`` (a
short run, its choices against the study's zoo), and the study's cells:
the mean destroyed by a sign flip, the trimmed mean and Multi-Krum
rescuing training, on the bundled digits. The study draws its own
numbers (``torch.Generator``), so the JAX package's cells are matched in
what they show (the accuracy bounds), not digit for digit; a cell is held
to itself under one seed exactly.
"""

import json
import subprocess
import sys

import pytest
import torch

from byzpy_tpu_torch import cli
from byzpy_tpu_torch.version import __version__


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The study's rounds are thousands of small operations. With torch's
    default of one intra-op thread a core, a worker of a parallel pytest
    run spins that many threads against the other workers' at every
    operation: ``test_gossip_cell_mean_poisoned_robust_rescued`` took 392 s
    (4 s alone) in a ``-n 6 --dist loadfile`` run and burned 469 s of CPU
    beside five busy processes, against 21 s with one thread. One thread
    runs the module as an idle machine would; the previous count is
    restored after it."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_version_imports_no_torch():
    code = ("import sys; from byzpy_tpu_torch import cli; rc = cli.main(['version']); "
            "assert 'torch' not in sys.modules, 'torch imported'; sys.exit(rc)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == __version__
    out = subprocess.run([sys.executable, "-m", "byzpy_tpu_torch.cli", "version"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == __version__


def test_doctor_json(capsys):
    assert cli.main(["doctor", "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["version"] == __version__
    assert report["torch"]["ok"] and report["torch"]["version"] == torch.__version__
    assert report["device_count"] == torch.cuda.device_count()
    assert "native_shm_store" in report and "nvcc" in report
    kernels = report["kernels"]
    if report["nvcc"]["path"] is None:
        # no nvcc here: the build is reported as failed, not skipped
        assert kernels["ok"] is False and "nvcc not found" in kernels["error"]
    else:
        assert kernels["ok"], kernels
    assert cli.main(["doctor", "--no-build"]) == 0
    assert "kernels" not in capsys.readouterr().out


def test_doctor_probe_times_out_instead_of_hanging(monkeypatch):
    import time

    monkeypatch.setenv("BYZPY_TPU_TORCH_DOCTOR_TIMEOUT", "0.2")
    with pytest.raises(TimeoutError, match="did not answer"):
        cli._with_timeout(lambda: time.sleep(60), cli._probe_timeout(20.0), "a stuck probe")

    def boom():
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        cli._with_timeout(boom, 1.0, "a failing probe")
    monkeypatch.setenv("BYZPY_TPU_TORCH_DOCTOR_TIMEOUT", "20s")
    assert cli._probe_timeout(7.0) == 7.0


@pytest.mark.parametrize("kind", ["aggregators", "attacks", "pre-aggregators"])
def test_list_names_the_reference_classes(kind, capsys):
    from byzpy_tpu import cli as ref_cli

    assert cli.main(["list", kind]) == 0
    ours = {line.split("\t")[0] for line in capsys.readouterr().out.splitlines()}
    # what the JAX CLI lists in a fresh process: the classes of its own
    # package for the kind (another test module in this process may have
    # imported a subclass from elsewhere, as byzpy_tpu.chaos.clients does)
    package = "byzpy_tpu." + kind.replace("-", "_") + "."
    ref = {cls.__name__ for cls in ref_cli._collect(kind) if cls.__module__.startswith(package)}
    assert len(ref) >= 4
    # every class the JAX package lists is listed by the port
    assert ref <= ours, sorted(ref - ours)


def test_lint_is_not_in_the_parser():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["lint"])


def test_bench_on_the_cpu(capsys):
    rc = cli.main(["bench", "--nodes", "8", "--dim", "1024", "--repeat", "2", "--device", "cpu"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert report["shape"] == [8, 1024] and report["device"] == "cpu"
    assert report["clock"] == "host"
    for op in ("coordinate_median", "trimmed_mean", "multi_krum", "geometric_median"):
        assert "ms" in report[op], report[op]
        assert report[op]["ms"] > 0


def test_bench_without_a_card_reports_the_probe():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is reachable")
    report = cli.bench_report(n=4, d=64, repeat=1)
    assert "CUDA is not available" in report["error"]


def test_study_parser_and_short_run(capsys):
    pytest.importorskip("sklearn")
    assert cli.main(["study", "--rounds", "2", "--aggregator", "median", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "| aggregator | sign_flip |" in out
    assert "median" in out and "mean" in out


def test_study_choices_match_the_zoo():
    from byzpy_tpu_torch.utils import robust_study

    parser = cli.build_parser()
    sub = next(a for a in parser._subparsers._group_actions).choices["study"]
    by_dest = {a.dest: a for a in sub._actions}
    assert tuple(by_dest["aggregator"].choices) == robust_study.STUDY_AGGREGATORS
    assert tuple(by_dest["attack"].choices) == robust_study.STUDY_ATTACKS
    assert robust_study.STUDY_AGGREGATORS == cli.STUDY_AGGREGATORS
    assert robust_study.STUDY_ATTACKS == cli.STUDY_ATTACKS


# -- the study's cells ---------------------------------------------------------


@pytest.fixture(scope="module")
def digits():
    pytest.importorskip("sklearn")
    from byzpy_tpu_torch.models.data import load_digits_dataset

    return load_digits_dataset(seed=0, device="cpu")


def _bundle():
    from byzpy_tpu_torch.models.nets import digits_mlp

    return digits_mlp(seed=0, device="cpu")


@pytest.mark.parametrize("agg,attack,low,high", [
    ("mean", "sign_flip", 0.0, 0.5),
    ("trimmed_mean", "sign_flip", 0.8, 1.0),
    ("multi_krum", "little", 0.8, 1.0),
    ("mean", "none", 0.9, 1.0),
])
def test_study_cell_accuracy_contract(digits, agg, attack, low, high):
    """The JAX package's contracts (tests/test_robust_learning.py) at its
    120 rounds."""
    from byzpy_tpu_torch.utils.robust_study import StudyConfig, run_cell

    cell = run_cell(_bundle, digits, agg, attack, StudyConfig(rounds=120, eval_every=60))
    assert low <= cell.final_accuracy <= high, cell.row()
    assert [r for r, _ in cell.history] == [60, 120]


def test_gossip_cell_mean_poisoned_robust_rescued(digits):
    from byzpy_tpu_torch.utils.robust_study import StudyConfig, run_gossip_cell

    cfg = StudyConfig(rounds=120, eval_every=60)
    poisoned = run_gossip_cell(_bundle, digits, "mean", "sign_flip", cfg)
    rescued = run_gossip_cell(_bundle, digits, "trimmed_mean", "sign_flip", cfg)
    assert poisoned.final_accuracy < 0.5, poisoned.row()
    assert rescued.final_accuracy > 0.8, rescued.row()
    with pytest.raises(ValueError, match="grad_dtype"):
        run_gossip_cell(_bundle, digits, "mean", "none", StudyConfig(rounds=1, grad_dtype="bfloat16"))


@pytest.mark.parametrize("agg", ["mean", "median", "trimmed_mean", "multi_krum",
                                 "geometric_median", "nnm_trimmed_mean"])
@pytest.mark.parametrize("attack", ["none", "sign_flip", "empire", "little", "gaussian", "mimic"])
def test_study_zoo_cell_is_seed_deterministic(digits, agg, attack):
    """Every member of the zoo under every attack trains; a cell run twice
    under one seed gives the same accuracies exactly."""
    from byzpy_tpu_torch.utils.robust_study import StudyConfig, run_cell

    cfg = StudyConfig(rounds=3, eval_every=3, seed=7)
    a = run_cell(_bundle, digits, agg, attack, cfg)
    b = run_cell(_bundle, digits, agg, attack, cfg)
    assert a.history == b.history
    assert 0.0 <= a.final_accuracy <= 1.0


def test_named_zoo_members_pickle_and_refuse_unknown_names():
    import pickle

    from byzpy_tpu_torch.utils import robust_study

    for name in robust_study.STUDY_AGGREGATORS:
        pickle.dumps(robust_study.named_aggregator(name, n_nodes=8, n_byzantine=2))
    for name in robust_study.STUDY_ATTACKS:
        pickle.dumps(robust_study.named_attack(name, n_byzantine=2, n_nodes=8))
    with pytest.raises(ValueError, match="unknown aggregator"):
        robust_study.named_aggregator("caf", n_nodes=8, n_byzantine=2)
    with pytest.raises(ValueError, match="unknown attack"):
        robust_study.named_attack("ipm", n_byzantine=2, n_nodes=8)
    with pytest.raises(ValueError, match="mode"):
        robust_study.run_study(mode="ring", device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        robust_study.run_cell(_bundle, (None, None, None, None), "mean", "none",
                              robust_study.StudyConfig(rounds=1), mesh=object())


def test_study_on_synthetic_data_without_scikit_learn(capsys, monkeypatch):
    """``--data synthetic`` runs the study on blobs of the digits' shape and
    never loads scikit-learn (hosts without it)."""
    import sys

    monkeypatch.setitem(sys.modules, "sklearn", None)
    assert cli.main(["study", "--rounds", "2", "--data", "synthetic", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "| aggregator | sign_flip |" in out and "trimmed_mean" in out
    x_train, y_train, x_test, y_test = cli._synthetic_digits(0, "cpu")
    assert x_train.shape[1:] == (8, 8, 1) and x_train.shape[0] + x_test.shape[0] == 1797
