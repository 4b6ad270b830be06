"""Java task driver (ref drivers/java/driver.go): launch a jar or class
under the JVM, optionally inside the nsexec isolation shepherd the exec
driver uses.

Task config:
  jar_path     path to the jar (mutually exclusive with class)
  class        main class (uses class_path)
  class_path   -cp value (default task dir)
  jvm_options  list of JVM flags (-Xmx512m, ...)
  args         program arguments
"""

from __future__ import annotations

import shutil
import subprocess

from ..client.driver import RawExecDriver, TaskHandle
from ..structs.model import Task


class JavaDriver(RawExecDriver):
    name = "java"

    def __init__(self, binary: str = ""):
        super().__init__()
        self._java = binary or shutil.which("java")
        self._version = ""
        if self._java:
            self._version = self._probe_version()

    def _probe_version(self) -> str:
        """``java -version`` prints like 'openjdk version "11.0.2" ...'
        on stderr (ref java/driver.go parseJavaVersionOutput)."""
        try:
            out = subprocess.run(
                [self._java, "-version"],
                capture_output=True,
                text=True,
                timeout=10,
            )
            for line in (out.stderr + out.stdout).splitlines():
                if "version" in line and '"' in line:
                    return line.split('"')[1]
        except (OSError, subprocess.TimeoutExpired):
            pass
        return ""

    def fingerprint(self) -> dict:
        detected = bool(self._java)
        attrs = {}
        if detected:
            attrs["driver.java.version"] = self._version
        return {"detected": detected, "healthy": detected, "attributes": attrs}

    def start_task(self, task: Task, task_dir: str) -> TaskHandle:
        if not self._java:
            raise RuntimeError("java runtime not found on this node")
        cfg = task.config or {}
        jar = cfg.get("jar_path")
        main_class = cfg.get("class")
        if bool(jar) == bool(main_class):
            raise RuntimeError("java requires exactly one of jar_path/class")
        argv = [self._java] + list(cfg.get("jvm_options", []))
        if jar:
            argv += ["-jar", jar]
        else:
            argv += ["-cp", cfg.get("class_path", task_dir or "."), main_class]
        argv += [str(a) for a in cfg.get("args", [])]
        return self._spawn(task, argv, task_dir or None)
