"""Local provider — the development "cloud": real grid processes; the
port's counterpart of :mod:`pygrid_tpu.infra.providers.local`.

No reference analog (its providers only target clouds; local dev is
``docker-compose.yml``). Renders a compose-style process table and, on
``deploy(apply=True)``, actually spawns the port's servers with
``subprocess`` and ``sys.executable`` — the programmatic twin of the
reference's compose file (1 network + N nodes,
``docker-compose.yml:3-76``). A spawned node holds its tensors on
``config.gpu.device`` (``cuda`` by default), and the child imports the
same ``pygrid_tpu_torch`` as the deployer (its directory leads the child's
``PYTHONPATH``)."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

from pygrid_tpu_torch.infra.providers.base import Provider, server_command, shell_line

#: the directory that holds the ``pygrid_tpu_torch`` package
_PACKAGE_ROOT = str(Path(__file__).resolve().parents[3])


class LocalProvider(Provider):
    name = "local"

    def __init__(self, config) -> None:
        super().__init__(config)
        self.processes: list[subprocess.Popen] = []

    def command(self) -> list[str]:
        cmd = server_command(self.config)
        return [sys.executable, *cmd[1:]] if cmd[0] == "python" else cmd

    def render(self) -> dict[str, str]:
        return {
            "run.sh": "#!/bin/bash\nexec " + shell_line(self.command()) + "\n",
        }

    def deploy(self, apply: bool = False) -> dict:
        result = super().deploy(apply=False)
        if apply:
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH")) if p
            )
            proc = subprocess.Popen(self.command(), env=env)
            self.processes.append(proc)
            result["pid"] = proc.pid
            result["applied"] = True
        return result

    def destroy(self) -> bool:
        for proc in self.processes:
            proc.terminate()
        for proc in self.processes:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        self.processes.clear()
        return True
