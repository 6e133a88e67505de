# Copied from quickstep_tpu/cli/network.py; only the package name in imports and main differ (the server takes the device and a device memory budget).
"""Network CLI: SQL-over-TCP server + client.

Capability parity with the reference's network CLI (cli/NetworkIO.hpp:245 — a gRPC
service with one rpc SendQuery(QueryRequest) returns QueryResponse,
cli/NetworkCli.proto:22-24 — plus NetworkCliClientMain). gRPC is replaced by a
length-prefixed JSON frame protocol over TCP (no proto toolchain needed; same
single-roundtrip request/response shape):

  request:  {"query": "<sql>"}
  response: {"stdout": "<formatted rows>", "stderr": "<error text>",
             "rows": [[...]], "columns": [...], "time_ms": float}

Server: python -m quickstep_tpu_torch.cli.network --port 3000 [--storage_path ...]
Client: python -m quickstep_tpu_torch.cli.network --connect host:3000 -c "SELECT 1;"
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import sys
import threading
import time
from typing import Optional

_HDR = struct.Struct(">I")


def _send_frame(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_HDR.pack(len(data)) + data)


def _recv_frame(sock: socket.socket) -> Optional[dict]:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return json.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class QueryServer:
    """Serves SendQuery requests against one Database.

    Concurrent clients are admitted and scheduled by a PolicyEnforcer
    (exec/scheduler.py): up to `max_concurrent_queries` admitted at once,
    dispatched fairly by (priority DESC, least-recently-served session,
    arrival) — the reference's multi-query admission semantics
    (query_execution/PolicyEnforcerSingleNode.cpp:42-56). Requests may carry
    an optional integer "priority" (parser ParsePriority analog)."""

    def __init__(self, db, host: str = "127.0.0.1", port: int = 3000,
                 max_concurrent_queries: int = 8):
        self.db = db
        # the Database's own PolicyEnforcer serves all paths (embedded, REPL,
        # network) — one admission domain, as the reference's single Foreman
        db.config.max_concurrent_queries = max_concurrent_queries
        self.enforcer = db.policy_enforcer
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                session = f"{self.client_address[0]}:{self.client_address[1]}"
                while True:
                    req = _recv_frame(self.request)
                    if req is None:
                        return
                    _send_frame(self.request, outer._run(req, session))

        self.server = socketserver.ThreadingTCPServer((host, port), Handler)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]

    def _run(self, req: dict, session: str = "default") -> dict:
        from quickstep_tpu_torch.errors import QuickstepError, SqlError
        sql = req.get("query", "")
        priority = int(req.get("priority", 0))
        t0 = time.perf_counter()
        try:
            res = self.db.execute(sql, session=session, priority=priority)
            out = {
                "stdout": res.to_table() if res and res.column_names else
                (res.message or f"{res.rows_affected} rows affected."
                 if res else ""),
                "stderr": "",
                "rows": [list(r) for r in (res.rows if res else [])],
                "columns": res.column_names if res else [],
                "time_ms": (time.perf_counter() - t0) * 1000,
            }
        except SqlError as e:
            out = {"stdout": "", "stderr": e.format(sql), "rows": [],
                   "columns": [], "time_ms": (time.perf_counter() - t0) * 1000}
        except QuickstepError as e:
            out = {"stdout": "", "stderr": f"ERROR: {e}", "rows": [],
                   "columns": [], "time_ms": (time.perf_counter() - t0) * 1000}
        return out

    def serve_forever(self):
        self.server.serve_forever()

    def shutdown(self):
        self.server.shutdown()
        self.server.server_close()
        self.enforcer.shutdown()


class QueryClient:
    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port))

    def query(self, sql: str) -> dict:
        _send_frame(self.sock, {"query": sql})
        resp = _recv_frame(self.sock)
        if resp is None:
            raise ConnectionError("server closed connection")
        return resp

    def close(self):
        self.sock.close()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(prog="quickstep_tpu_torch.cli.network")
    ap.add_argument("--port", type=int, default=3000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--storage_path", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the server's tables live (server mode; the "
                    "card unless the CPU is asked for)")
    ap.add_argument("--hbm_budget_bytes", default=0, type=int,
                    help="device memory budget of the server (0: none)")
    ap.add_argument("--connect", default=None, help="host:port (client mode)")
    ap.add_argument("-c", "--command", default=None)
    args = ap.parse_args(argv)

    if args.connect:
        host, _, port = args.connect.partition(":")
        client = QueryClient(host, int(port or 3000))
        if args.command:
            resp = client.query(args.command)
            if resp["stderr"]:
                print(resp["stderr"], file=sys.stderr)
            else:
                print(resp["stdout"])
                print(f"Time: {resp['time_ms']:.2f} ms")
        else:
            while True:
                try:
                    line = input("quickstep> ")
                except EOFError:
                    break
                if line.strip() in ("\\q", "quit"):
                    break
                resp = client.query(line)
                print(resp["stderr"] or resp["stdout"])
        client.close()
        return 0

    from quickstep_tpu_torch.config import Config
    from quickstep_tpu_torch.database import Database
    cfg = Config()
    cfg.hbm_budget_bytes = args.hbm_budget_bytes
    db = Database(config=cfg, storage_path=args.storage_path,
                  device=args.device)
    server = QueryServer(db, args.host, args.port)
    print(f"quickstep-tpu query server listening on {args.host}:{server.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
