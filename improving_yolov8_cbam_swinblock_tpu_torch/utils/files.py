"""Run directories (counterpart of the JAX package's utils/files.py:15-42):
every train run gets its own `runs/{task}/{name}{N}` unless `exist_ok`
or a resume pins it."""

from __future__ import annotations

from pathlib import Path


def increment_path(path, exist_ok: bool = False) -> Path:
    """runs/exp -> runs/exp2, runs/exp3, ... (a file keeps its suffix);
    unchanged with exist_ok or when the path does not exist yet."""
    path = Path(path)
    if path.exists() and not exist_ok:
        path, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = Path(f"{path}{n}{suffix}")
            if not p.exists():
                path = p
                break
    return path


def get_save_dir(args) -> Path:
    """project (default runs/{task}) / name (default 'train'), incremented
    unless exist_ok or resume."""
    project = getattr(args, "project", None) or f"runs/{getattr(args, 'task', None) or 'detect'}"
    name = getattr(args, "name", None) or "train"
    exist_ok = bool(getattr(args, "exist_ok", False)) or bool(getattr(args, "resume", False))
    return increment_path(Path(project) / name, exist_ok=exist_ok)
