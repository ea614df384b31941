"""Terraform runner — the port's counterpart of :mod:`pygrid_tpu.infra.tf`.

Parity: reference ``apps/infrastructure/api/tf.py:11-24`` — thin subprocess
wrappers over ``terraform init/validate/plan/apply/destroy`` in a working
directory. Adds ``available()`` so providers degrade to a dry run when the
binary is absent (CI, laptops)."""

from __future__ import annotations

import shutil
import subprocess


class Terraform:
    def available(self) -> bool:
        return shutil.which("terraform") is not None

    def _run(self, args: list[str], dir: str) -> int:
        return subprocess.call(["terraform", *args], cwd=dir)

    def init(self, dir: str) -> int:
        return self._run(["init", "-input=false"], dir)

    def validate(self, dir: str) -> int:
        return self._run(["validate"], dir)

    def plan(self, dir: str) -> int:
        return self._run(["plan", "-input=false"], dir)

    def apply(self, dir: str) -> int:
        return self._run(["apply", "-input=false", "-auto-approve"], dir)

    def destroy(self, dir: str) -> int:
        return self._run(["destroy", "-input=false", "-auto-approve"], dir)
