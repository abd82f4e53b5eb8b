"""The load generator of the daemon cells, run in a process of its own
(no card, no torch) so that its threads do not take the interpreter lock
from the daemon's:

    python -m benchmark.http_client <plan.json> <out.json>

The plan gives the daemon's port, the time the load starts
(``time.monotonic``, which every process of the machine shares) and either

  * ``requests``: an open loop of POST /synthesize, each due at its own
    offset and sent then, whatever is still in flight (a pool of threads;
    a request the pool sends late is still timed from when it was due), or
  * ``sessions``: live streams, each a thread that POSTs its pushes in
    order, each due on a fixed schedule.

Every call is timed from when it was due to its reply; the replies' bodies
are kept only for the calls the plan names.
"""

from __future__ import annotations

import base64
import http.client
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def post(port, path, payload, timeout):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = json.dumps(payload)
        conn.request("POST", path, body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def sleep_until(t):
    while True:
        left = t - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def timed_call(port, path, payload, due, timeout, keep):
    sent = time.monotonic()
    try:
        status, body = post(port, path, payload, timeout)
    except OSError as e:
        status, body = 0, json.dumps({"error": str(e)}).encode()
    done = time.monotonic()
    rec = {"due": due, "sent": sent, "done": done, "status": status}
    try:
        reply = json.loads(body)
    except ValueError:
        reply = {}
    for k in ("latency_ms", "batch_size", "session_id", "error"):
        if k in reply:
            rec[k] = reply[k]
    if keep:
        rec["reply"] = reply
    return rec


def open_loop(plan):
    uploads = [base64.b64encode(Path(p).read_bytes()).decode() for p in plan.get("uploads", [])]
    start, port, timeout = plan["start"], plan["port"], plan["timeout"]
    keep = set(plan.get("keep", []))
    with ThreadPoolExecutor(max_workers=plan.get("threads", 128)) as pool:
        futures = []
        for i, req in enumerate(plan["requests"]):
            payload = dict(req["payload"])
            if "upload" in req:
                payload["styles"] = [{"bvh_b64": uploads[req["upload"]],
                                      "frames": req.get("frames")}]
            due = start + req["due"]
            sleep_until(due)
            futures.append(pool.submit(timed_call, port, "/synthesize", payload, due, timeout,
                                       i in keep))
        return [f.result() for f in futures]


def sessions(plan):
    start, port, timeout = plan["start"], plan["port"], plan["timeout"]
    keep = set(plan.get("keep", []))
    out = [None] * len(plan["sessions"])

    def run(s, sess):
        recs = []
        for j, push in enumerate(sess["pushes"]):
            due = start + push["due"]
            sleep_until(due)
            payload = {"session_id": sess["session_id"], "audio_f32_b64": push["audio"]}
            recs.append(timed_call(port, "/stream/push", payload, due, timeout, s in keep))
        out[s] = recs

    threads = [threading.Thread(target=run, args=(s, sess)) for s, sess in
               enumerate(plan["sessions"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def main(argv):
    plan = json.loads(Path(argv[0]).read_text())
    result = open_loop(plan) if "requests" in plan else sessions(plan)
    Path(argv[1]).write_text(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
