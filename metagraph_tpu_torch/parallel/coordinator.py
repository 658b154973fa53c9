"""Job coordinator: the work-queue layer for builds spread over hosts.

Counterpart of ``metagraph_tpu/parallel/coordinator.py``, which replaces
the reference's cloud work queue (metagraph/scripts/cloud/server.py:88-230,
client.py): a coordinator hands jobs (per-suffix build commands) to
worker processes over HTTP, tracks pending work, and re-queues a job
when a worker nacks it or its lease runs out.

Workers run the port's CLI on their jobs; artifacts land in a shared
directory and ``concatenate`` combines them.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional


@dataclass
class Job:
    job_id: int
    payload: dict
    attempts: int = 0
    max_attempts: int = 3


class WorkQueue:
    """Thread-safe pending/active bookkeeping with ack/nack + retry
    (the reference server's per-operation pending sets)."""

    def __init__(self, jobs: List[dict], max_attempts: int = 3,
                 lease_seconds: float = 3600.0):
        self._lock = threading.Lock()
        self._pending: List[Job] = [
            Job(i, payload, max_attempts=max_attempts)
            for i, payload in enumerate(jobs)]
        self._active: Dict[int, tuple] = {}   # job_id -> (job, deadline)
        self._done: Dict[int, dict] = {}
        self._failed: Dict[int, Job] = {}
        self._lease = lease_seconds

    def acquire(self, worker: str) -> Optional[Job]:
        with self._lock:
            self._reap_expired()
            if not self._pending:
                return None
            job = self._pending.pop(0)
            job.attempts += 1
            self._active[job.job_id] = (job, time.time() + self._lease)
            return job

    def ack(self, job_id: int, result: Optional[dict] = None) -> bool:
        with self._lock:
            entry = self._active.pop(job_id, None)
            if entry is None:
                return False
            self._done[job_id] = result or {}
            return True

    def nack(self, job_id: int) -> bool:
        with self._lock:
            entry = self._active.pop(job_id, None)
            if entry is None:
                return False
            job = entry[0]
            if job.attempts >= job.max_attempts:
                self._failed[job_id] = job
            else:
                self._pending.append(job)
            return True

    def _reap_expired(self):
        now = time.time()
        for job_id, (job, deadline) in list(self._active.items()):
            if deadline < now:
                del self._active[job_id]
                if job.attempts >= job.max_attempts:
                    self._failed[job_id] = job
                else:
                    self._pending.append(job)

    def status(self) -> dict:
        with self._lock:
            self._reap_expired()
            return {
                "pending": len(self._pending),
                "active": len(self._active),
                "done": len(self._done),
                "failed": len(self._failed),
            }

    def finished(self) -> bool:
        st = self.status()
        return st["pending"] == 0 and st["active"] == 0


def make_handler(queue: WorkQueue):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/status":
                self._send(queue.status())
            else:
                self._send({"error": "not found"}, 404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/acquire":
                job = queue.acquire(payload.get("worker", "?"))
                if job is None:
                    self._send({"job": None})
                else:
                    self._send({"job": {"id": job.job_id,
                                        "payload": job.payload}})
            elif self.path == "/ack":
                self._send({"ok": queue.ack(payload["id"],
                                            payload.get("result"))})
            elif self.path == "/nack":
                self._send({"ok": queue.nack(payload["id"])})
            else:
                self._send({"error": "not found"}, 404)

        def log_message(self, fmt, *args):
            pass

    return Handler


def serve_queue(jobs: List[dict], host: str = "127.0.0.1", port: int = 0,
                **kw):
    """Start the coordinator; returns (httpd, queue). Port 0 = ephemeral."""
    queue = WorkQueue(jobs, **kw)
    httpd = ThreadingHTTPServer((host, port), make_handler(queue))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, queue


class Worker:
    """Pulls jobs and runs them as CLI invocations (reference client.py)."""

    def __init__(self, server: str, name: str = "worker"):
        self.server = server.rstrip("/")
        self.name = name
        self.reached = False       # the coordinator has answered once

    def _post(self, endpoint: str, payload: dict) -> dict:
        req = urllib.request.Request(
            f"{self.server}/{endpoint}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req) as r:
            out = json.loads(r.read())
        self.reached = True
        return out

    def run_one(self, execute=None) -> bool:
        """Acquire + run + ack/nack one job; False when queue is empty."""
        resp = self._post("acquire", {"worker": self.name})
        job = resp.get("job")
        if job is None:
            return False
        try:
            if execute is not None:
                result = execute(job["payload"])
            else:
                result = self._default_execute(job["payload"])
            self._post("ack", {"id": job["id"], "result": result})
        except Exception:
            self._post("nack", {"id": job["id"]})
        return True

    def run_until_empty(self, execute=None, poll_seconds: float = 1.0):
        """Run jobs until the queue is drained. A coordinator that
        closes the connection after answering once has shut down with its
        queue drained (its command waits for no worker): the worker stops
        too. One never reached (not yet bound, a wrong address) raises."""
        while True:
            try:
                if self.run_one(execute):
                    continue
                status = json.loads(urllib.request.urlopen(
                    f"{self.server}/status").read())
            except (ConnectionError, urllib.error.URLError) as e:
                if self.reached and (isinstance(e, ConnectionError)
                                     or isinstance(e.reason,
                                                   ConnectionError)):
                    return
                raise
            if status["pending"] == 0 and status["active"] == 0:
                return
            time.sleep(poll_seconds)

    @staticmethod
    def _default_execute(payload: dict) -> dict:
        """The default job: one command of the port's CLI."""
        proc = subprocess.run(
            [sys.executable, "-m", "metagraph_tpu_torch.cli.main"]
            + payload["argv"], capture_output=True,
            timeout=payload.get("timeout", 86400))
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr.decode()[-2000:])
        return {"returncode": 0}
