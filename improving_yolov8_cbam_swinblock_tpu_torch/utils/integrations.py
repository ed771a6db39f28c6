"""Logger integrations on the callback bus (the port's copy of the JAX
package's utils/integrations.py). Every run appends one JSON object per
epoch to <save_dir>/metrics.jsonl; TensorBoard logs through
torch.utils.tensorboard where it imports (and SETTINGS["tensorboard"] is
on). The hosted loggers (wandb, mlflow, comet, clearml, dvclive, neptune)
each register where their package imports, as in the JAX package, and only
with SETTINGS["hosted_loggers"] on (off by default; the JAX package has no
such switch): their init reaches a server or asks for its key, and a
package that is installed is not a request to log to it."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List


def _epoch_row(trainer) -> Dict:
    return trainer.metrics_rows[-1] if trainer.metrics_rows else {}


def _scalars(row: Dict) -> Dict[str, float]:
    return {k: v for k, v in row.items() if isinstance(v, (int, float)) and k != "epoch"}


def add_tensorboard(callbacks: Dict[str, List], log_dir: str) -> bool:
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return False
    writer = SummaryWriter(str(log_dir))

    def on_fit_epoch_end(trainer):
        row = _epoch_row(trainer)
        for k, v in _scalars(row).items():
            writer.add_scalar(k, v, int(row.get("epoch", 0)))
        writer.flush()

    def on_train_end(trainer):
        writer.close()

    callbacks["on_fit_epoch_end"].append(on_fit_epoch_end)
    callbacks["on_train_end"].append(on_train_end)
    return True


def add_jsonl(callbacks: Dict[str, List], log_path: str) -> bool:
    """One JSON object per epoch, the row of results.csv; needs no package."""
    path = Path(log_path)

    def on_fit_epoch_end(trainer):
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as fh:
            fh.write(json.dumps(_epoch_row(trainer)) + "\n")

    callbacks["on_fit_epoch_end"].append(on_fit_epoch_end)
    return True


def add_wandb(callbacks: Dict[str, List], project: str, name: str) -> bool:
    try:
        import wandb
    except ImportError:
        return False
    run = wandb.init(project=project.replace("/", "-"), name=name, resume="allow")

    def on_fit_epoch_end(trainer):
        row = _epoch_row(trainer)
        run.log(_scalars(row), step=int(row.get("epoch", 0)))

    def on_train_end(trainer):
        best = trainer.wdir / "best.pt"
        if best.exists():
            art = wandb.Artifact(f"run_{run.id}_model", type="model")
            art.add_file(str(best))
            run.log_artifact(art, aliases=["best"])
        run.finish()

    callbacks["on_fit_epoch_end"].append(on_fit_epoch_end)
    callbacks["on_train_end"].append(on_train_end)
    return True


def add_mlflow(callbacks: Dict[str, List], experiment: str, run_name: str) -> bool:
    try:
        import mlflow
    except ImportError:
        return False
    mlflow.set_experiment(experiment or "/Shared/YOLO")
    mlflow.start_run(run_name=run_name)

    def on_pretrain_routine_end(trainer):
        mlflow.log_params({k: str(v) for k, v in vars(trainer.args).items()})

    def on_fit_epoch_end(trainer):
        row = _epoch_row(trainer)
        mlflow.log_metrics({k.replace("(", "").replace(")", ""): float(v) for k, v in _scalars(row).items()},
                           step=int(row.get("epoch", 0)))

    def on_train_end(trainer):
        for f in (trainer.wdir / "best.pt", trainer.save_dir / "results.csv"):
            if f.exists():
                mlflow.log_artifact(str(f))
        mlflow.end_run()

    callbacks["on_pretrain_routine_end"].append(on_pretrain_routine_end)
    callbacks["on_fit_epoch_end"].append(on_fit_epoch_end)
    callbacks["on_train_end"].append(on_train_end)
    return True


def add_comet(callbacks: Dict[str, List], project: str) -> bool:
    try:
        import comet_ml
    except ImportError:
        return False
    exp = comet_ml.Experiment(project_name=project or "yolo")

    def on_fit_epoch_end(trainer):
        row = _epoch_row(trainer)
        exp.log_metrics(_scalars(row), epoch=int(row.get("epoch", 0)))

    def on_train_end(trainer):
        best = trainer.wdir / "best.pt"
        if best.exists():
            exp.log_model("best", str(best))
        exp.end()

    callbacks["on_fit_epoch_end"].append(on_fit_epoch_end)
    callbacks["on_train_end"].append(on_train_end)
    return True


def add_clearml(callbacks: Dict[str, List], project: str, name: str) -> bool:
    try:
        from clearml import Task
    except ImportError:
        return False
    task = Task.init(project_name=project or "YOLO", task_name=name or "train")

    def on_fit_epoch_end(trainer):
        row = _epoch_row(trainer)
        for k, v in _scalars(row).items():
            task.get_logger().report_scalar("train", k, v, iteration=int(row.get("epoch", 0)))

    callbacks["on_fit_epoch_end"].append(on_fit_epoch_end)
    return True


def add_dvc(callbacks: Dict[str, List]) -> bool:
    try:
        from dvclive import Live
    except ImportError:
        return False
    live = Live(save_dvc_exp=True)

    def on_fit_epoch_end(trainer):
        for k, v in _scalars(_epoch_row(trainer)).items():
            live.log_metric(k, v)
        live.next_step()

    def on_train_end(trainer):
        live.end()

    callbacks["on_fit_epoch_end"].append(on_fit_epoch_end)
    callbacks["on_train_end"].append(on_train_end)
    return True


def add_neptune(callbacks: Dict[str, List], project: str, name: str) -> bool:
    try:
        import neptune
    except ImportError:
        return False
    run = neptune.init_run(project=project, name=name)

    def on_fit_epoch_end(trainer):
        row = _epoch_row(trainer)
        for k, v in _scalars(row).items():
            run[f"train/{k}"].append(v, step=int(row.get("epoch", 0)))

    callbacks["on_fit_epoch_end"].append(on_fit_epoch_end)
    return True


def add_integration_callbacks(trainer) -> Dict[str, bool]:
    """Attach the integrations to trainer.callbacks as the module docstring
    says; returns which registered."""
    from .settings import SETTINGS

    cb = trainer.callbacks
    project = str(getattr(trainer.args, "project", "") or "runs")
    name = str(getattr(trainer.args, "name", "") or "train")
    out = {"tensorboard": bool(SETTINGS.get("tensorboard", True)) and add_tensorboard(cb, str(trainer.save_dir / "tb")),
           "jsonl": add_jsonl(cb, str(trainer.save_dir / "metrics.jsonl"))}
    hosted = bool(SETTINGS.get("hosted_loggers", False))
    out.update(wandb=hosted and add_wandb(cb, project, name), mlflow=hosted and add_mlflow(cb, project, name),
               comet=hosted and add_comet(cb, project), clearml=hosted and add_clearml(cb, project, name),
               dvc=hosted and add_dvc(cb), neptune=hosted and add_neptune(cb, project, name))
    return out
