"""The elastic supervisor and manager (counterpart of
paddle_tpu/distributed/fleet/elastic.py:20-203, the reference's
fleet/elastic/manager.py:124 membership watch and :220 relaunch).

Membership is a heartbeat file per rank in a directory (``PADDLE_ELASTIC_DIR``,
default a per-supervisor directory under the system's temporary
directory). ``ElasticSupervisor`` spawns the pod's worker processes,
watches their exit codes and heartbeats, and relaunches the whole pod
when one dies or hangs; state continuity comes from checkpoint and
resume. Plain Python: the workers are whatever commands it is given
(the port's ranks hold their CUDA contexts in those processes).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Callable, Optional

__all__ = ["ElasticManager", "ElasticStatus", "ElasticSupervisor",
           "scale_np"]


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    def __init__(self, args=None, etcd_client=None, heartbeat_dir=None,
                 np=None, host=None, interval=3):
        self.np = np or int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.host = host or os.environ.get("POD_IP", "127.0.0.1")
        self.rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.dir = heartbeat_dir or os.environ.get(
            "PADDLE_ELASTIC_DIR", os.path.join(tempfile.gettempdir(),
                                               "paddle_elastic"))
        self.interval = interval
        self.enable = self.np > 1 or os.environ.get(
            "PADDLE_ELASTIC_ENABLE") == "1"
        self._stop = threading.Event()
        self._thread = None
        self.on_scale: Optional[Callable] = None
        self.elastic_level = int(os.environ.get(
            "PADDLE_ELASTIC_FAULT_TOLERANC_LEVEL", "1"))

    def _beat_path(self, rank):
        return os.path.join(self.dir, f"rank_{rank}.beat")

    def start(self):
        if not self.enable:
            return
        os.makedirs(self.dir, exist_ok=True)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            with open(self._beat_path(self.rank), "w") as f:
                json.dump({"ts": time.time(), "host": self.host}, f)
            self._stop.wait(self.interval)

    def watch(self):
        """Return current membership status (the reference polls etcd)."""
        if not self.enable:
            return ElasticStatus.COMPLETED
        now = time.time()
        alive = 0
        for r in range(self.np):
            p = self._beat_path(r)
            if os.path.exists(p):
                try:
                    with open(p) as f:
                        beat = json.load(f)
                    if now - beat["ts"] < 6 * self.interval:
                        alive += 1
                except (json.JSONDecodeError, OSError):
                    pass
        if alive < self.np:
            if self.on_scale:
                self.on_scale(alive, self.np)
            return ElasticStatus.RESTART
        return ElasticStatus.HOLD

    def exit(self, completed=True):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1)
        try:
            os.remove(self._beat_path(self.rank))
        except OSError:
            pass
        return ElasticStatus.COMPLETED if completed else ElasticStatus.ERROR


def scale_np(np_new):
    """Request a new world size (the reference's
    distributed/elastic.py:21-43)."""
    os.environ["PADDLE_ELASTIC_NP"] = str(np_new)
    return np_new


class ElasticSupervisor:
    """The relaunch half of the reference ElasticManager (manager.py:124
    watch loop + :220 relaunch): spawns the worker processes, watches
    process liveness + heartbeat files, and relaunches the whole pod when
    membership drops (the reference also restarts every trainer — state
    continuity comes from checkpoint/resume).

    Used by the launcher under --elastic_level >= 1, and directly."""

    def __init__(self, cmds, envs=None, heartbeat_dir=None, interval=0.5,
                 max_restarts=3, heartbeat_timeout=None, log=print):
        self.cmds = list(cmds)
        self.envs = list(envs) if envs is not None \
            else [dict(os.environ)] * len(self.cmds)
        # per-supervisor unique default: a shared dir would let two jobs
        # on one host delete/misread each other's heartbeats
        self.dir = heartbeat_dir or os.environ.get("PADDLE_ELASTIC_DIR") \
            or os.path.join(tempfile.gettempdir(),
                            f"paddle_elastic_{os.getpid()}")
        for env in self.envs:
            env.setdefault("PADDLE_ELASTIC_DIR", self.dir)
        self.interval = interval
        self.max_restarts = max_restarts
        # hang detection: a rank that HAS written heartbeats (workers
        # opt in by running ElasticManager.start()) and then goes silent
        # longer than this is treated as dead even though its process is
        # alive (deadlocked collective). None -> 20x poll interval.
        self.heartbeat_timeout = heartbeat_timeout or 20 * interval
        self.restarts = 0
        self._procs = []
        self._log = log

    def _spawn(self):
        import subprocess
        os.makedirs(self.dir, exist_ok=True)
        # stale beats from the previous incarnation must not mask a death
        for name in os.listdir(self.dir):
            if name.endswith(".beat"):
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass
        self._procs = [subprocess.Popen(cmd, env=env)
                       for cmd, env in zip(self.cmds, self.envs)]

    def _kill_all(self):
        for p in self._procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + 5
        for p in self._procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.time()))
            except Exception:
                p.kill()

    def _stale_ranks(self):
        """Ranks whose process is still RUNNING but whose heartbeat went
        silent for longer than heartbeat_timeout — alive-but-hung
        workers. Ranks that already exited (cleanly or not) are the
        exit-code path's business, not a hang."""
        import json
        stale = []
        now = time.time()
        for rank, proc in enumerate(self._procs):
            if proc.poll() is not None:
                continue  # exited: not hung
            path = os.path.join(self.dir, f"rank_{rank}.beat")
            if not os.path.exists(path):
                continue  # this worker never opted into heartbeats
            try:
                with open(path) as f:
                    beat = json.load(f)
                if now - beat["ts"] > self.heartbeat_timeout:
                    stale.append(rank)
            except (json.JSONDecodeError, OSError, KeyError):
                pass  # mid-write; next poll decides
        return stale

    def run(self) -> int:
        """Supervise until every worker exits 0 (returns 0) or
        max_restarts is exhausted (returns the first failed worker's
        exit code, or 1 when giving up on a hang)."""
        self._spawn()
        while True:
            time.sleep(self.interval)
            codes = [p.poll() for p in self._procs]
            if all(c == 0 for c in codes):
                return 0
            dead = [i for i, c in enumerate(codes)
                    if c is not None and c != 0]
            hung = [] if dead else self._stale_ranks()
            if dead or hung:
                if self.restarts >= self.max_restarts:
                    self._kill_all()
                    self._log(f"ELASTIC giving up after "
                              f"{self.restarts} restarts "
                              f"(dead={dead}, hung={hung})")
                    return codes[dead[0]] if dead else 1
                self.restarts += 1
                self._log(f"ELASTIC worker(s) dead={dead} hung={hung} "
                          f"(codes={codes}); relaunch #{self.restarts}")
                self._kill_all()
                self._spawn()
