"""Persistent user settings (the port's copy of the JAX package's
utils/settings.py): a versioned JSON at $XDG_CONFIG_HOME (or ~/.config)
/improving_yolov8_cbam_swinblock_tpu_torch/settings.json with dict access,
update() and reset(). Its keys are the ones the port reads: `datasets_dir`
(where a packaged dataset descriptor's relative `path:` is anchored, as in
the JAX package), `tensorboard` (as in the JAX package), `clip_npz` (as in
the JAX package: a CLIP text-tower archive that utils/text_model.py's
encode_texts uses where its caller names none; empty: the hash projection)
and `hosted_loggers`, which the JAX package lacks: off by default, it lets
the hosted loggers of utils/integrations.py register."""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict

SETTINGS_VERSION = "0.1.0"


def _config_dir() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME") or str(Path.home() / ".config")
    return Path(base) / "improving_yolov8_cbam_swinblock_tpu_torch"


class SettingsManager(dict):
    """The settings as a dict backed by the JSON file; a file with other keys
    or another version keeps the known keys and takes the defaults for the rest."""

    def __init__(self, file: Path | None = None):
        self.file = Path(file) if file else _config_dir() / "settings.json"
        root = Path.cwd()
        self.defaults: Dict[str, Any] = {
            "settings_version": SETTINGS_VERSION,
            "datasets_dir": str(root / "datasets"),
            "tensorboard": True,
            "hosted_loggers": False,
            "clip_npz": "",
        }
        super().__init__(self.defaults)
        try:
            if self.file.exists():
                loaded = json.loads(self.file.read_text())
                if set(loaded) == set(self.defaults) and loaded.get("settings_version") == SETTINGS_VERSION:
                    self.update(loaded)
                else:
                    self.update({k: v for k, v in loaded.items() if k in self.defaults})
                    self["settings_version"] = SETTINGS_VERSION
                    self.save()
            else:
                self.save()
        except (OSError, ValueError):
            pass  # an unreadable or unwritable settings file never stops the library

    def save(self):
        self.file.parent.mkdir(parents=True, exist_ok=True)
        self.file.write_text(json.dumps(dict(self), indent=2))

    def update(self, *args, **kwargs):
        super().update(*args, **kwargs)
        return self

    def reset(self):
        self.clear()
        super().update(self.defaults)
        self.save()
        return self


SETTINGS = SettingsManager()
