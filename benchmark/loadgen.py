"""The load generator, run as a process of its own (python3 loadgen.py), so
that its parsing and the server's threads never share an interpreter lock.

It reads one JSON object from standard input (the configuration, the
traffic parameters and the seed, from which it builds the schedule with
traffic.build, and the server's address),
prints "ready", waits for a line {"t_start": ..., "t_end": ...} (times on
the monotonic clock, which every process of the machine shares), drives
the schedule with one asyncio loop and plain HTTP/1.1 connections, and
prints one JSON list of request records on standard output.

A closed-loop client sends its next request when its reply is complete
and sends none after t_end. An open loop sends each request when it is
due (t_start + due), whether or not earlier ones finished; a request is
timed from when it was due, and `sent` - due is how late the generator
ran. After t_end the generator waits (up to grace_s) until every request
it sent has its first token, then closes every connection: what is still
running is cut (a streamed reply keeps the text that arrived), and only
what finished counts as finished.
"""

from __future__ import annotations

import asyncio
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.gguf_file import ids_to_text, text_to_ids  # noqa: E402
from benchmark.traffic import build, prompt_ids  # noqa: E402


class Run:
    def __init__(self, spec: dict):
        self.spec = spec
        self.cfg = spec["cfg"]
        self.V = self.cfg["vocab_size"]
        self.sched = build(spec["cfg"], spec["traffic"], spec["seed"],
                           spec["traffic"].get("n_requests", 1024))
        self.records: list = []
        self.open_conns: set = set()

    async def post(self, body: dict, rec: dict) -> None:
        """POST /v1/chat/completions; fills rec with the reply's times,
        text and timings (or error)."""
        data = json.dumps(body, ensure_ascii=False).encode("utf-8")
        reader, writer = await asyncio.open_connection(self.spec["host"],
                                                       self.spec["port"])
        self.open_conns.add(writer)
        try:
            writer.write(b"POST /v1/chat/completions HTTP/1.1\r\n"
                         b"Host: localhost\r\nContent-Type: application/json\r\n"
                         b"Connection: close\r\n"
                         + f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
            await writer.drain()
            rec["sent"] = time.monotonic()
            status = int((await reader.readline()).split()[1])
            headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                headers[k.strip().lower()] = v.strip()
            if status != 200:
                body_b = await reader.read()
                rec["error"] = f"HTTP {status}: {body_b[:200]!r}"
                return
            if headers.get("transfer-encoding", "").lower() == "chunked":
                await self._read_sse(reader, rec)
            else:
                raw = await reader.readexactly(int(headers["content-length"]))
                t = time.monotonic()
                obj = json.loads(raw)
                if "error" in obj:
                    rec["error"] = str(obj["error"])[:200]
                    return
                ch = obj["choices"][0]
                text = ch["message"]["content"] or ""
                rec.update(first=t, last=t, done=t, text=text,
                           finish=ch.get("finish_reason"),
                           timings=obj.get("timings") or {},
                           events=[[t, len(text)]])
        finally:
            self.open_conns.discard(writer)
            writer.close()

    async def _read_sse(self, reader, rec: dict) -> None:
        """Reads the stream into rec; what arrived is kept as its text also
        where the stream is cut (the window closed) or fails."""
        parts: list = []
        try:
            await self._read_events(reader, rec, parts)
        finally:
            rec["text"] = "".join(parts)

    async def _read_events(self, reader, rec: dict, parts: list) -> None:
        buf = b""
        events: list = []
        rec["events"] = events
        while True:
            size_line = await reader.readline()
            if not size_line:
                rec["error"] = "connection closed mid-stream"
                return
            size = int(size_line.strip() or b"0", 16)
            if size == 0:
                break
            buf += await reader.readexactly(size)
            await reader.readexactly(2)
            t = time.monotonic()
            while b"\n\n" in buf:
                ev, buf = buf.split(b"\n\n", 1)
                if not ev.startswith(b"data: "):
                    continue
                payload = ev[6:]
                if payload == b"[DONE]":
                    continue
                obj = json.loads(payload)
                if "error" in obj:
                    rec["error"] = str(obj["error"])[:200]
                    return
                ch = obj["choices"][0] if obj.get("choices") else {}
                piece = (ch.get("delta") or {}).get("content") or ""
                if piece:
                    parts.append(piece)
                    events.append([t, len(piece)])
                    rec.setdefault("first", t)
                    rec["last"] = t
                if ch.get("finish_reason"):
                    rec["finish"] = ch["finish_reason"]
                    rec["timings"] = obj.get("timings") or {}
        rec["done"] = time.monotonic()

    def _body(self, messages: list, max_tokens: int, fields: dict) -> dict:
        msgs = [{"role": r, "content": ids_to_text(ids, self.V)} for r, ids in messages]
        body = {"model": self.spec["model"], "messages": msgs,
                "max_tokens": max_tokens, "stream": self.sched["stream"]}
        body.update(fields)
        return body

    async def one(self, rec: dict, messages: list, max_tokens: int,
                  fields: dict) -> dict:
        rec.update(prompt_len=len(prompt_ids(self.cfg, messages)),
                   max_tokens=max_tokens)
        self.records.append(rec)
        try:
            await self.post(self._body(messages, max_tokens, fields), rec)
        except (OSError, ValueError, KeyError, IndexError,
                asyncio.IncompleteReadError) as e:
            rec.setdefault("error", f"{type(e).__name__}: {e}")
        return rec

    def record(self, client: int, k: int, req: dict, due: float | None) -> dict:
        return {"client": client, "k": k, "due": due, "greedy": req["greedy"],
                "fields": req["fields"], "messages": req.get("messages")}

    async def closed_client(self, c: int, items: list) -> None:
        await asyncio.sleep(max(0.0, self.t_start + self.stagger * c
                                - time.monotonic()))
        k = 0
        for item in items:
            if "turns" not in item:  # a single request
                if time.monotonic() >= self.t_end:
                    return
                rec = self.record(c, k, item, time.monotonic())
                k += 1
                await self.one(rec, item["messages"], item["max_tokens"],
                               item["fields"])
                continue
            msgs = [("system", item["system"])]
            for turn in item["turns"]:
                if time.monotonic() >= self.t_end:
                    return
                msgs = msgs + [("user", turn["user"])]
                if (len(prompt_ids(self.cfg, msgs)) + turn["max_tokens"]
                        > item["max_history"]):
                    break
                rec = self.record(c, k, item, time.monotonic())
                rec["messages"] = msgs
                k += 1
                await self.one(rec, msgs, turn["max_tokens"], item["fields"])
                if "error" in rec or rec.get("done") is None:
                    break
                msgs = msgs + [("assistant", text_to_ids(rec["text"], self.V))]

    async def open_loop(self, reqs: list) -> None:
        for k, req in enumerate(reqs):
            due = self.t_start + req["due"]
            if due >= self.t_end:
                break
            await asyncio.sleep(max(0.0, due - time.monotonic()))
            rec = self.record(0, k, req, due)
            self.open_tasks.append(asyncio.create_task(
                self.one(rec, req["messages"], req["max_tokens"], req["fields"])))

    async def main(self, t_start: float, t_end: float) -> list:
        self.t_start, self.t_end = t_start, t_end
        self.open_tasks: list = []
        if self.sched["loop"] == "open":
            senders = [asyncio.create_task(self.open_loop(self.sched["requests"]))]
        else:
            cl = self.sched["clients"]
            self.stagger = self.sched.get("stagger_s", 0.0) / max(len(cl), 1)
            senders = [asyncio.create_task(self.closed_client(c, items))
                       for c, items in enumerate(cl)]
        await asyncio.sleep(max(0.0, t_end - time.monotonic()))
        deadline = t_end + float(self.spec.get("grace_s", 30.0))
        while self.sched["stream"] and time.monotonic() < deadline and any(
                "first" not in r and "error" not in r for r in self.records):
            await asyncio.sleep(0.02)
        for d in senders + self.open_tasks:
            d.cancel()
        for w in list(self.open_conns):
            w.close()
        await asyncio.gather(*senders, *self.open_tasks, return_exceptions=True)
        return self.records


def main() -> int:
    spec = json.loads(sys.stdin.readline())
    run = Run(spec)
    print("ready", flush=True)
    window = json.loads(sys.stdin.readline())
    records = asyncio.run(run.main(window["t_start"], window["t_end"]))
    sys.stdout.write(json.dumps(records) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
