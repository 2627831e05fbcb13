"""Async serving gateway: the fleet's durable HTTP front door (counterpart
of ``paddle_tpu/serving/gateway.py``; the same routes, status codes and
response bodies, keys included).

A dependency-free asyncio HTTP/1.1 server exposing OpenAI-compatible
endpoints over a :class:`~paddle_tpu_torch.serving.router.FleetRouter`:

- ``POST /v1/completions`` and ``POST /v1/chat/completions`` — prompts are
  token-id lists (the repo has no tokenizer; a string prompt is parsed as
  whitespace-separated ids). ``"stream": true`` answers Server-Sent Events
  with one chunk per decoded token *as the engine produces it* and a final
  ``data: [DONE]``; replica failover happens mid-stream without the client
  seeing a seam (the router replays and suppresses already-sent tokens).
- Per-request **deadline budget**: ``deadline_ms`` in the body (or an
  ``x-deadline-ms`` header) rides the dispatch into the engine's
  per-request deadline; a missed deadline ends the request with
  ``finish_reason: "deadline"`` and whatever tokens made it out.
- **Load shedding**: a :class:`~paddle_tpu_torch.serving.router.RouterShed`
  becomes ``429 Too Many Requests`` with a ``Retry-After`` header derived
  from the fleet's observed SLO window (an honest hint, not a constant);
  :class:`~paddle_tpu_torch.serving.router.NoHealthyReplica` becomes ``503``.
  ``priority`` in the body (int, default 0, higher = keep longer) feeds
  the router's shed-lowest-first policy.
- Operations: ``GET /healthz`` (fleet health; 503 when no replica is
  healthy), ``GET /metrics`` (Prometheus text exposition of the global
  registry), ``GET /stats`` (the router's JSON fleet view + a ``gateway``
  block: journal state, recovery report, retained streams),
  ``GET /v1/models``.

Durable request lifecycle, on when
``journal_dir`` is set:

- **Write-ahead journal** (:mod:`paddle_tpu_torch.serving.journal`): every
  accepted request is journaled *before* it is submitted, token
  watermarks ride the router's ``on_watermark`` callback, and the
  terminal record carries the full result. A journal append failure
  refuses the request (500) — durability is never silently dropped.
- **Crash recovery**: a restarted ``Gateway(journal_dir=...)`` scans the
  journal and re-submits every accepted-non-terminal request through the
  router's replay-and-suppress path (``submit(replay_tokens=...)``): the
  journaled prefix is regenerated, verified token-for-token, and
  swallowed — zero accepted requests are lost to a gateway SIGKILL.
- **Idempotency keys**: an ``Idempotency-Key`` request header dedupes
  client retries — in-flight → the retry attaches to the live request;
  terminal → the recorded result is replayed byte-identically; unknown →
  a new admission. At-least-once retries become exactly-once semantics.
- **Resumable SSE**: every token chunk carries a monotonic ``id:`` line;
  a reconnecting client sends ``Last-Event-ID`` (on an idempotent retry
  POST or ``GET /v1/streams/<id>``) and receives exactly the missing
  suffix. A dropped connection does not cancel the request (the decode
  keeps running for the reconnect) unless ``cancel_on_disconnect`` says
  otherwise.

Multi-tenancy, on when a
``tenancy=`` :class:`~paddle_tpu_torch.serving.tenancy.TenantRegistry` is
passed: the ``Authorization`` header (``Bearer <key>`` or a bare key)
resolves to a tenant identity — a missing or unknown key answers ``401``
with ``{"error": {"type": "authentication_error", ...}}`` when any API
key is configured — and each tenant's token bucket rate-limits admission
(``429`` whose ``Retry-After`` is that tenant's own bucket-refill
horizon, not the fleet-wide estimate). The resolved tenant rides the
submit into the scheduler's weighted-fair queue and the per-tenant cost
attribution, and ``GET /stats`` gains ``tenancy`` (registry + admission
counts) and, when an ``autoscaler=`` is attached, ``autoscaler`` blocks.

The server runs on a daemon thread with its own event loop so synchronous
callers (benchmarks, the soak harness, tests) can ``start()``/``stop()`` it
around plain-socket clients; the loop never touches an engine (replicas
step their engines on their own threads or processes). Fault sites:
``gateway.request`` fires per parsed request (an injected error answers
500 — the connection layer survives); ``gateway.auth`` fires per tenant
resolution and fails **closed** (an injected error answers 401, never
admits as anonymous); ``gateway.journal.append`` /
``gateway.journal.fsync`` live in the journal.
"""
from __future__ import annotations

import asyncio
import json
import math
import threading
import time
import urllib.parse
import uuid
from types import SimpleNamespace

from .. import telemetry
from ..telemetry import reqtrace
from ..utils import faults
from .journal import Journal, JournalError
from .router import NoHealthyReplica, RouterShed
from .tenancy import AuthError, TenantRegistry
from ..analysis import locksan

__all__ = ["Gateway"]

_SERVER = "paddle-tpu-gateway"

# The /v1/dashboard page: zero external assets (no CDN fonts, no JS
# frameworks) so it renders inside an airgapped pod. Inline JS polls the
# JSON endpoints this same gateway serves.
_DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>paddle_tpu ops — __GATEWAY_ID__</title>
<style>
 body{font:13px/1.45 system-ui,sans-serif;margin:0;background:#0d1117;color:#c9d1d9}
 h1{font-size:16px;margin:0;padding:10px 16px;background:#161b22;border-bottom:1px solid #30363d}
 h1 small{color:#8b949e;font-weight:normal}
 h2{font-size:13px;color:#8b949e;margin:18px 16px 6px;text-transform:uppercase;letter-spacing:.05em}
 table{border-collapse:collapse;margin:0 16px;width:calc(100% - 32px)}
 th,td{text-align:left;padding:3px 10px;border-bottom:1px solid #21262d;font-size:12px}
 th{color:#8b949e;font-weight:normal}
 .page{color:#f85149;font-weight:bold}.ticket{color:#d29922}.info{color:#58a6ff}
 .firing{color:#f85149}.pending{color:#d29922}.resolved{color:#3fb950}
 .ok{color:#3fb950}.muted{color:#484f58}
 .charts{display:flex;flex-wrap:wrap;gap:10px;margin:0 16px}
 .chart{background:#161b22;border:1px solid #30363d;border-radius:6px;padding:8px 10px}
 .chart .name{font-size:11px;color:#8b949e}.chart .val{font-size:14px}
 svg polyline{fill:none;stroke:#58a6ff;stroke-width:1.5}
 .bar{background:#1f6feb;height:10px;display:inline-block;vertical-align:middle}
 .stack{font:11px ui-monospace,monospace;white-space:nowrap;overflow:hidden;text-overflow:ellipsis;max-width:60vw;display:inline-block;vertical-align:middle}
 #err{color:#f85149;padding:4px 16px}
</style></head><body>
<h1>paddle_tpu ops plane <small>· gateway __GATEWAY_ID__ · <span id="asof"
 class="muted"></span></small></h1>
<div id="err"></div>
<h2>Alerts <span id="alertsum"></span></h2>
<table id="alerts"><thead><tr><th>rule</th><th>key</th><th>severity</th>
<th>state</th><th>value</th><th>exemplar</th><th>description</th></tr></thead>
<tbody></tbody></table>
<h2>History</h2><div class="charts" id="charts"></div>
<h2>Profiler <span id="profsum" class="muted"></span></h2>
<table id="prof"><thead><tr><th>samples</th><th>stack</th></tr></thead>
<tbody></tbody></table>
<script>
const $=(s)=>document.querySelector(s);
const fmt=(v)=>v==null?"–":(Math.abs(v)>=100?v.toFixed(0):Math.abs(v)>=1?v.toFixed(2):v.toPrecision(3));
const scalar=(v)=>typeof v==="number"?v:(v&&(v.mean??v.p99??v.rate??v.last))??null;
async function jget(u){const r=await fetch(u);if(!r.ok)throw new Error(u+" -> "+r.status);return r.json();}
async function alerts(){
 const d=await jget("/v1/alerts");
 const tb=$("#alerts tbody");tb.innerHTML="";
 $("#alertsum").innerHTML=d.enabled===false?'<span class=muted>(no engine attached)</span>'
  :(d.firing?'<span class=firing>'+d.firing+' firing</span>':'<span class=ok>all clear</span>')
  +' <span class=muted>· '+(d.pending||0)+' pending · '+(d.rules||[]).length+' rules · eval #'+(d.evaluations||0)+'</span>';
 const rows=(d.alerts||[]).concat((d.resolved||[]).slice(-5));
 if(!rows.length){tb.innerHTML='<tr><td colspan=7 class=muted>nothing pending, nothing firing</td></tr>';}
 for(const a of rows){
  const tr=document.createElement("tr");
  const ex=a.exemplar?'<a href="/v1/traces/'+a.exemplar+'">'+a.exemplar+'</a>':"–";
  tr.innerHTML='<td>'+a.rule+'</td><td>'+(a.key||"–")+'</td><td class='+a.severity+'>'+a.severity
   +'</td><td class='+a.state+'>'+a.state+'</td><td>'+fmt(a.value)+'</td><td>'+ex
   +'</td><td class=muted>'+(a.description||"")+'</td>';
  tb.appendChild(tr);}
}
function spark(pts){
 const vs=pts.map(p=>scalar(p.v)).filter(v=>v!=null);
 if(vs.length<2)return{svg:"",last:vs[0]};
 const w=180,h=36,mn=Math.min(...vs),mx=Math.max(...vs),span=(mx-mn)||1;
 const xs=vs.map((v,i)=>((i/(vs.length-1))*w).toFixed(1)+","+((h-2)-(v-mn)/span*(h-4)).toFixed(1));
 return{svg:'<svg width='+w+' height='+h+'><polyline points="'+xs.join(" ")+'"/></svg>',last:vs[vs.length-1]};
}
async function charts(){
 const list=await jget("/v1/history");
 const box=$("#charts");box.innerHTML="";
 if(list.enabled===false){box.innerHTML='<span class=muted>(no history store attached)</span>';return;}
 const prefer=["slo_goodput_ratio","slo_ttft_p99_seconds","slo_tpot_p99_seconds",
  "gateway_request_seconds","gateway_requests_total","router_breaker_state",
  "alerts_firing","journal_segments","history_overhead_frac","pyprof_overhead_frac"];
 const have=new Set((list.families||[]).map(f=>f.family));
 const fams=prefer.filter(f=>have.has(f)).slice(0,10);
 for(const fam of fams){
  const q=await jget("/v1/history?family="+fam+"&window=300");
  for(const s of (q.series||[]).slice(0,3)){
   const sp=spark(s.points||[]);
   const lbl=Object.entries(s.labels||{}).map(([k,v])=>k+"="+v).join(",");
   const div=document.createElement("div");div.className="chart";
   div.innerHTML='<div class=name>'+fam+(lbl?"{"+lbl+"}":"")+'</div>'
    +'<div class=val>'+fmt(sp.last)+'</div>'+sp.svg;
   box.appendChild(div);}}
}
async function prof(){
 const st=await jget("/v1/profile?format=stats");
 const tb=$("#prof tbody");tb.innerHTML="";
 if(st.enabled===false){$("#profsum").textContent="(no profiler attached)";return;}
 $("#profsum").textContent=st.hz+" Hz · "+st.samples+" samples · overhead "
  +(100*(st.overhead_frac||0)).toFixed(2)+"%";
 const txt=await (await fetch("/v1/profile?format=folded")).text();
 const rows=txt.trim().split("\\n").filter(Boolean).map(l=>{
  const i=l.lastIndexOf(" ");return [l.slice(0,i),parseInt(l.slice(i+1))];})
  .sort((a,b)=>b[1]-a[1]).slice(0,15);
 const mx=rows.length?rows[0][1]:1;
 for(const [stack,n] of rows){
  const tr=document.createElement("tr");
  tr.innerHTML='<td><span class=bar style="width:'+(80*n/mx)+'px"></span> '+n
   +'</td><td><span class=stack title="'+stack+'">'+stack+'</span></td>';
  tb.appendChild(tr);}
}
async function tick(fns){
 try{await Promise.all(fns.map(f=>f()));$("#err").textContent="";}
 catch(e){$("#err").textContent=String(e);}
 $("#asof").textContent=new Date().toLocaleTimeString();
}
tick([alerts,charts,prof]);
setInterval(()=>tick([alerts]),2000);
setInterval(()=>tick([charts]),3000);
setInterval(()=>tick([prof]),5000);
</script></body></html>
"""


def _gateway_metrics() -> SimpleNamespace:
    reg = telemetry.registry()
    return SimpleNamespace(
        requests=reg.counter(
            "gateway_requests_total", "HTTP requests by route", ("route",)),
        responses=reg.counter(
            "gateway_responses_total", "HTTP responses by status code",
            ("code",)),
        shed=reg.counter(
            "gateway_shed_total", "requests answered 429 (load shed)"),
        tokens=reg.counter(
            "gateway_streamed_tokens_total", "tokens written to clients"),
        active=reg.gauge(
            "gateway_active_streams", "SSE streams currently open"),
        latency=reg.histogram(
            "gateway_request_seconds",
            "wall time from request parse to response end"),
        resumes=reg.counter(
            "gateway_resumes_total",
            "SSE streams resumed from a Last-Event-ID watermark"),
        recovered=reg.counter(
            "gateway_recovered_requests_total",
            "accepted-non-terminal requests re-submitted from the journal "
            "at startup"),
        idem_hits=reg.counter(
            "gateway_idempotent_hits_total",
            "requests deduplicated by Idempotency-Key", ("outcome",)),
        conn_errors=reg.counter(
            "gateway_conn_errors_total",
            "connections dropped by an unexpected error in the serve loop "
            "(client vanished mid-request, protocol desync)"),
        auth_failures=reg.counter(
            "gateway_auth_failures_total",
            "requests answered 401 (missing/unknown API key, or the "
            "gateway.auth fault site failing closed)"),
        tenant_shed=reg.counter(
            "gateway_tenant_shed_total",
            "requests answered 429 by the tenant's own token bucket "
            "(fleet-wide sheds count in gateway_shed_total only)",
            ("tenant",)),
    )


def _parse_tokens(v, what: str) -> list[int]:
    if isinstance(v, str):
        v = v.split()
    if not isinstance(v, (list, tuple)):
        raise ValueError(f"{what} must be a token-id list (or a string of "
                         f"whitespace-separated ids)")
    try:
        return [int(t) for t in v]
    except (TypeError, ValueError):
        raise ValueError(f"{what} contains a non-integer token id")


class _HTTPError(Exception):
    def __init__(self, status: int, message: str, headers=(),
                 close: bool = False, err_type: str | None = None):
        super().__init__(message)
        self.status = status
        self.headers = list(headers)
        self.err_type = err_type          # overrides the status-derived
                                          # "type" in the error JSON body
        # close=True: the connection's framing can no longer be trusted
        # (unread body bytes, garbled request line) — answering and then
        # parsing the leftover bytes as a "request" would wedge the
        # connection state machine
        self.close = close


_REASONS = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
            404: "Not Found",
            405: "Method Not Allowed", 408: "Request Timeout",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable"}


class _Stream:
    """Gateway-side durable handle for one accepted request: the fan-out
    point SSE subscribers attach to (first connection and reconnects
    alike), the journal watermark cursor, and the snapshot an idempotent
    retry replays. Lives in the gateway's bounded stream registry under
    both its journal id (= trace id) and its completion id."""

    def __init__(self, jid: str, *, chat: bool, created: int,
                 prompt_len: int, idem: str | None = None,
                 priority: int = 0, recovered: bool = False,
                 tenant: str = "anonymous"):
        self.jid = jid
        self.chat = chat
        self.created = created
        self.prompt_len = prompt_len
        self.idem = idem
        self.priority = priority
        self.recovered = recovered
        self.tenant = tenant
        self.rr = None                    # live RouterRequest (may be None
        self.rid: str | None = None       # for journal-replayed terminals)
        self.tokens: list[int] = []
        self.marked = 0                   # journal watermark cursor
        self.state = "running"
        self.finish_reason: str | None = None
        self.error: str | None = None
        self.replica: str | None = None
        self.failovers = 0
        self.retries = 0
        self.subscribers: list = []       # (loop, asyncio.Queue)
        self.done = threading.Event()

    @property
    def terminal(self) -> bool:
        return self.state != "running"


class Gateway:
    """HTTP front door over a started :class:`FleetRouter`.

    host/port:          bind address (port 0 = ephemeral; read ``.port``
                        after :meth:`start`).
    default_deadline_s: applied when a request names no deadline (None =
                        unbounded).
    max_body_bytes:     request-body bound (413-by-400 beyond it; the
                        connection closes — its framing is unrecoverable).
    journal_dir:        enable the durable request lifecycle: write-ahead
                        journal + crash recovery + idempotency replay
                        (None = stateless gateway, in-memory resume only).
    journal_fsync:      the journal's fsync policy (always|interval|never).
    journal_watermark_every: token-watermark journal cadence.
    gateway_id:         stable identity stamped into journal records
                        (defaults to a fresh ``gw-<hex>``).
    resume_retention:   how many *terminal* streams stay attachable for
                        idempotent replay / late ``Last-Event-ID`` resume.
    cancel_on_disconnect: cancel the engine work when an SSE client hangs
                        up (default: True without a journal — the old
                        behavior — False with one, so the stream survives
                        for the reconnect).
    recover:            scan the journal and re-submit accepted-
                        non-terminal requests during :meth:`start`.
    """

    def __init__(self, router, host: str = "127.0.0.1", port: int = 0, *,
                 default_deadline_s: float | None = None,
                 max_body_bytes: int = 1 << 20,
                 model_name: str = "paddle-tpu",
                 journal_dir: str | None = None,
                 journal_fsync: str = "interval",
                 journal_kwargs: dict | None = None,
                 journal_watermark_every: int = 8,
                 gateway_id: str | None = None,
                 resume_retention: int = 512,
                 cancel_on_disconnect: bool | None = None,
                 recover: bool = True,
                 tenancy=None, autoscaler=None,
                 history=None, alerts=None, profiler=None,
                 remediation=None, rollout_factory=None):
        self.router = router
        # self-healing control plane (serving.remediation / .rollout):
        # when attached, /stats grows remediation + rollout blocks and
        # the /v1/admin/* endpoints (fleet_ctl's surface) come alive.
        # rollout_factory(spec, env, **kw) -> RollingUpgrade lets the
        # harness inject ledger/alert wiring without the gateway knowing
        # the supervisor topology.
        self.remediation = remediation
        self.rollout_factory = rollout_factory
        self._rollout = None                  # the active RollingUpgrade
        self._rollout_thread = None
        # the ops plane (telemetry.history / .alerts / .pyprof): when
        # attached, the gateway serves /v1/history, /v1/alerts,
        # /v1/profile, and the /v1/dashboard HTML over them. All three
        # are optional and independent.
        self.history = history
        self.alerts = alerts
        self.profiler = profiler
        # multi-tenant front door (serving.tenancy): API-key -> tenant
        # resolution (401 on unknown keys when any key is configured) and
        # per-tenant token-bucket admission (429 with a bucket-refill
        # Retry-After). tenancy=None runs everything as "anonymous".
        if isinstance(tenancy, dict):
            tenancy = TenantRegistry.from_dict(tenancy)
        self.tenancy = tenancy if tenancy is not None else TenantRegistry()
        self.autoscaler = autoscaler      # optional: surfaces in /stats
        self.host = host
        self.port = int(port)
        self.default_deadline_s = default_deadline_s
        self.max_body_bytes = int(max_body_bytes)
        self.model_name = model_name
        self.gateway_id = gateway_id or f"gw-{uuid.uuid4().hex[:8]}"
        # journal_kwargs passes segment/compaction/retention knobs
        # through (segment_max_records, compact_segments,
        # retain_terminal, ...) — the soak harness shrinks them so
        # compaction cycles happen on test timescales
        self.journal = (Journal(journal_dir, fsync=journal_fsync,
                                **(journal_kwargs or {}))
                        if journal_dir else None)
        self.journal_watermark_every = int(journal_watermark_every)
        self.resume_retention = int(resume_retention)
        self.cancel_on_disconnect = (cancel_on_disconnect
                                     if cancel_on_disconnect is not None
                                     else self.journal is None)
        self._recover_on_start = bool(recover)
        self.recovery_report: dict | None = None
        self._m = _gateway_metrics()
        self._slock = locksan.Lock("gateway.streams")
        self._streams: dict[str, _Stream] = {}    # jid AND rid -> stream
        self._stream_order: list[str] = []        # jids, acceptance order
        self._idem: dict[str, str] = {}           # idempotency key -> jid
        self._loop: asyncio.AbstractEventLoop | None = None
        self._server: asyncio.AbstractServer | None = None
        self._thread: threading.Thread | None = None
        self._ready = threading.Event()
        self._startup_error: BaseException | None = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, timeout: float = 10.0) -> "Gateway":
        """Recover journaled requests (when enabled), then bind and serve
        on a daemon thread; returns once listening."""
        if self.journal is not None and self._recover_on_start:
            self.recover()
        self._thread = threading.Thread(
            target=self._run, name="gateway", daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout):
            raise TimeoutError("gateway failed to start listening")
        if self._startup_error is not None:
            raise self._startup_error
        return self

    def stop(self, timeout: float = 10.0):
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._thread is not None:
                self._thread.join(timeout)
        if self.journal is not None and not self.journal.closed:
            self.journal.close()

    def crash(self):
        """Chaos/test helper: die like a SIGKILL — no terminal journal
        records, no graceful stream shutdown. The journal file is left
        exactly as the last append left it, which is the whole point."""
        if self.journal is not None:
            self.journal.closed = True     # appends now raise; no cleanup
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
            if self._thread is not None:
                self._thread.join(5)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _run(self):
        loop = self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        try:
            server = loop.run_until_complete(asyncio.start_server(
                self._serve_conn, self.host, self.port))
        except BaseException as e:                  # bind failure
            self._startup_error = e
            self._ready.set()
            return
        self._server = server
        self.port = server.sockets[0].getsockname()[1]
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            server.close()
            loop.run_until_complete(server.wait_closed())
            tasks = asyncio.all_tasks(loop)
            for t in tasks:
                t.cancel()
            if tasks:
                loop.run_until_complete(
                    asyncio.gather(*tasks, return_exceptions=True))
            loop.close()

    # -- stream registry ---------------------------------------------------
    def _register_stream(self, st: _Stream):
        with self._slock:
            self._streams[st.jid] = st
            self._stream_order.append(st.jid)
            if st.idem:
                self._idem[st.idem] = st.jid
            self._prune_streams_locked()

    def _bind_stream(self, st: _Stream, rid: str):
        st.rid = rid
        with self._slock:
            self._streams[rid] = st

    def _prune_streams_locked(self):
        """Bound retained *terminal* streams; a live stream is never
        dropped (its tokens are the resume source of truth)."""
        n_terminal = sum(1 for j in self._stream_order
                         if self._streams[j].terminal)
        if n_terminal <= self.resume_retention:
            return
        for jid in list(self._stream_order):
            st = self._streams.get(jid)
            if st is None or not st.terminal:
                continue
            self._stream_order.remove(jid)
            self._streams.pop(jid, None)
            if st.rid:
                self._streams.pop(st.rid, None)
            if st.idem and self._idem.get(st.idem) == jid:
                del self._idem[st.idem]
            n_terminal -= 1
            if n_terminal <= self.resume_retention:
                break

    def _find_stream(self, key: str) -> _Stream | None:
        with self._slock:
            return self._streams.get(key)

    def _find_idem(self, key: str) -> _Stream | None:
        with self._slock:
            jid = self._idem.get(key)
            return self._streams.get(jid) if jid else None

    def _subscribe(self, st: _Stream, from_idx: int):
        """Atomically snapshot the already-delivered suffix and register a
        live queue: everything before the snapshot boundary is returned,
        everything after lands on the queue — no token is ever skipped or
        duplicated between the two."""
        q: asyncio.Queue = asyncio.Queue()
        with self._slock:
            snapshot = list(st.tokens[from_idx:])
            terminal = st.terminal
            if not terminal:
                st.subscribers.append((self._loop, q))
        return q, snapshot, terminal

    def _unsubscribe(self, st: _Stream, q):
        with self._slock:
            st.subscribers = [(lo, qq) for lo, qq in st.subscribers
                              if qq is not q]

    # -- router callbacks (replica reader threads) -------------------------
    def _stream_cbs(self, st: _Stream):
        def push(subs, item):
            # router callbacks may arrive with router.state held (terminal
            # _finish fan-out): the loop wakeup is a self-pipe write to a
            # non-blocking socketpair, so holding a lock across it is safe
            with locksan.allow_blocking(
                    "asyncio call_soon_threadsafe self-pipe wakeup: "
                    "non-blocking socketpair write, never blocks"):
                for loop, q in subs:
                    try:
                        loop.call_soon_threadsafe(q.put_nowait, item)
                    except RuntimeError:
                        pass  # loop gone (gateway stopped/crashed): the
                              # subscriber is dead, the stream lives on

        def on_token(rr, tok):
            with self._slock:
                st.tokens.append(int(tok))
                i = len(st.tokens) - 1
                subs = list(st.subscribers)
            push(subs, ("tok", i, int(tok)))

        def on_watermark(rr, n):
            if self.journal is None:
                return
            with self._slock:
                if n <= st.marked:
                    return
                suffix = st.tokens[st.marked:n]
                st.marked = n
            try:
                self.journal.mark(st.jid, n, suffix)
            except JournalError:
                pass     # the terminal record is the durable truth; a
                         # missed watermark only widens the replay window

        def on_finish(rr):
            with self._slock:
                st.state = rr.state
                st.finish_reason = rr.finish_reason
                st.error = rr.error
                st.replica = rr.replica
                st.failovers = rr.failovers
                st.retries = rr.retries
                subs = list(st.subscribers)
            if self.journal is not None:
                try:
                    self.journal.end(st.jid, state=st.state,
                                     reason=st.finish_reason,
                                     error=st.error, rid=st.rid,
                                     tokens=st.tokens)
                except JournalError:
                    pass   # crash-equivalent: recovery re-runs the tail
            st.done.set()
            push(subs, ("done", None, None))

        return on_token, on_watermark, on_finish

    # -- admission ---------------------------------------------------------
    def _accept(self, p: dict, chat: bool,
                idem: str | None) -> tuple[_Stream, bool]:
        """Admit one request: reserve the idempotency key, journal
        (write-ahead), then submit. Returns ``(stream, fresh)`` — fresh is
        False when the key already named a stream (the caller attaches or
        replays instead). Raises RouterShed / NoHealthyReplica /
        JournalError for the handler's status mapping.

        The key reservation and stream registration happen atomically
        *before* the submit, so two concurrent first submissions with the
        same key can never both generate — the loser of the race attaches
        to the winner's stream."""
        jid = reqtrace.new_trace_id()
        created = int(time.time())
        st = _Stream(jid, chat=chat, created=created,
                     prompt_len=len(p["prompt"]), idem=idem,
                     priority=p["priority"],
                     tenant=p.get("tenant") or "anonymous")
        with self._slock:
            if idem:
                existing = self._idem.get(idem)
                if existing is not None and existing in self._streams:
                    return self._streams[existing], False
                self._idem[idem] = jid
            self._streams[jid] = st
            self._stream_order.append(jid)
            self._prune_streams_locked()
        journaled = False
        on_token, on_wm, on_fin = self._stream_cbs(st)
        try:
            if self.journal is not None:
                # lint: allow-wallclock(deadline_unix is journaled and must survive process restarts)
                deadline_unix = (time.time() + p["deadline_s"]
                                 if p["deadline_s"] is not None else None)
                self.journal.accept(
                    jid, gateway_id=self.gateway_id, prompt=p["prompt"],
                    sampling=p["sampling"], priority=p["priority"],
                    deadline_unix=deadline_unix, idem=idem, chat=chat,
                    created=created, tenant=st.tenant)
                journaled = True
            rr = self.router.submit(
                p["prompt"], p["sampling"], priority=p["priority"],
                deadline_s=p["deadline_s"], on_token=on_token,
                on_finish=on_fin, trace_id=jid,
                on_watermark=on_wm if self.journal is not None else None,
                watermark_every=self.journal_watermark_every,
                tenant=st.tenant)
        except Exception as e:
            # the client is getting an error response right now — undo
            # the reservation, and make sure a future recovery does not
            # resurrect the journaled acceptance. Any attacher that won a
            # subscription in the meantime must be released, not hung.
            with self._slock:
                st.state = "failed"
                st.finish_reason = "rejected"
                st.error = f"{type(e).__name__}: {e}"
                subs = list(st.subscribers)
                self._streams.pop(jid, None)
                if jid in self._stream_order:
                    self._stream_order.remove(jid)
                if idem and self._idem.get(idem) == jid:
                    del self._idem[idem]
            st.done.set()
            with locksan.allow_blocking(
                    "asyncio call_soon_threadsafe self-pipe wakeup: "
                    "non-blocking socketpair write, never blocks"):
                for loop, q in subs:
                    try:
                        loop.call_soon_threadsafe(q.put_nowait,
                                                  ("done", None, None))
                    except RuntimeError:
                        pass
            if journaled:
                try:
                    self.journal.end(jid, state="rejected",
                                     reason=type(e).__name__)
                except JournalError:
                    pass
            raise
        st.rr = rr
        rid = f"{'chatcmpl' if chat else 'cmpl'}-{rr.gid}"
        self._bind_stream(st, rid)
        if self.journal is not None:
            try:
                self.journal.bind(jid, rid)
            except JournalError:
                pass
        return st, True

    # -- crash recovery ----------------------------------------------------
    def recover(self) -> dict:
        """Scan the journal and re-submit every accepted-non-terminal
        request through the router's replay-and-suppress path. Terminal
        entries rebuild the idempotency/resume registry so retries of
        pre-crash requests still replay their recorded results."""
        scan = self.journal.recovered
        report = {"scanned": len(scan.requests),
                  "torn_records": scan.torn_records,
                  "recovered": 0, "expired": 0, "restored_terminal": 0,
                  "failed": 0}
        for e in scan.terminal():
            a = e["accept"]
            if a is None:
                continue
            end = e["end"]
            if end.get("state") == "rejected":
                continue                  # never had a live submission
            st = _Stream(e["jid"], chat=bool(a.get("chat")),
                         created=int(a.get("created") or 0),
                         prompt_len=len(a.get("prompt") or ()),
                         idem=a.get("idem"), priority=a.get("priority", 0),
                         recovered=True)
            st.tokens = list(e["tokens"])
            st.marked = len(st.tokens)
            st.state = end.get("state") or "finished"
            st.finish_reason = end.get("reason")
            st.error = end.get("error")
            st.done.set()
            self._register_stream(st)
            if e["rid"]:
                self._bind_stream(st, e["rid"])
            report["restored_terminal"] += 1
        for e in scan.recoverable():
            a = e["accept"]
            jid = e["jid"]
            remaining = None
            if a.get("deadline_unix") is not None:
                # lint: allow-wallclock(deadline_unix in the journal is a wall stamp by design)
                remaining = float(a["deadline_unix"]) - time.time()
                if remaining <= 0:
                    # the deadline passed while no gateway was alive:
                    # terminal-ize it in the journal, keep it resumable
                    st = _Stream(jid, chat=bool(a.get("chat")),
                                 created=int(a.get("created") or 0),
                                 prompt_len=len(a.get("prompt") or ()),
                                 idem=a.get("idem"),
                                 priority=a.get("priority", 0),
                                 recovered=True)
                    st.tokens = list(e["tokens"])
                    st.marked = len(st.tokens)
                    st.state = "cancelled"
                    st.finish_reason = "deadline"
                    st.done.set()
                    self._register_stream(st)
                    if e["rid"]:
                        self._bind_stream(st, e["rid"])
                    try:
                        self.journal.end(jid, state="cancelled",
                                         reason="deadline", rid=e["rid"],
                                         tokens=e["tokens"])
                    except JournalError:
                        pass
                    report["expired"] += 1
                    continue
            st = _Stream(jid, chat=bool(a.get("chat")),
                         created=int(a.get("created") or 0),
                         prompt_len=len(a.get("prompt") or ()),
                         idem=a.get("idem"), priority=a.get("priority", 0),
                         recovered=True,
                         tenant=a.get("tenant") or "anonymous")
            st.tokens = list(e["tokens"])
            st.marked = e["n"]
            on_token, on_wm, on_fin = self._stream_cbs(st)
            try:
                rr = self.router.submit(
                    a["prompt"], a.get("sampling") or {},
                    priority=a.get("priority", 0), deadline_s=remaining,
                    on_token=on_token, on_finish=on_fin, trace_id=jid,
                    on_watermark=on_wm,
                    watermark_every=self.journal_watermark_every,
                    replay_tokens=e["tokens"], bypass_shed=True,
                    tenant=st.tenant)
            except Exception as ex:        # fleet not ready: keep journaled
                report["failed"] += 1
                telemetry.record_event("gateway.recover_failed", jid=jid,
                                       error=f"{type(ex).__name__}: {ex}")
                continue
            st.rr = rr
            rid = f"{'chatcmpl' if st.chat else 'cmpl'}-{rr.gid}"
            self._bind_stream(st, rid)
            try:
                self.journal.bind(jid, rid)
            except JournalError:
                pass
            self._register_stream(st)
            self._m.recovered.inc()
            report["recovered"] += 1
            telemetry.record_event("gateway.recovered", jid=jid,
                                   replayed=len(st.tokens))
        self.recovery_report = report
        telemetry.record_event("gateway.recovery", **{
            k: v for k, v in report.items()})
        return report

    # -- HTTP plumbing -----------------------------------------------------
    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter):
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except (asyncio.IncompleteReadError, ConnectionError):
                    break
                except _HTTPError as e:
                    # framing-level rejection (garbled request line, bad or
                    # oversized Content-Length): answer it, then close —
                    # these all leave unread bytes no parser can resync
                    await self._write_response(
                        writer, e.status,
                        {"error": {"message": str(e),
                                   "type": "invalid_request_error"}},
                        headers=e.headers)
                    break
                if req is None:
                    break
                keep = await self._handle(req, writer)
                if not keep:
                    break
        except Exception:
            # client vanished mid-request or the stream desynced: drop the
            # connection, but never invisibly
            self._m.conn_errors.inc()
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:  # lint: allow-silent(socket teardown; peer may already be gone)
                pass

    async def _read_request(self, reader):
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _ = line.decode("latin-1").split(None, 2)
        except ValueError:
            # the request line is garbage: there is no framing left to
            # trust, answer and hang up
            raise _HTTPError(400, "malformed request line", close=True)
        headers = {}
        while True:
            hl = await reader.readline()
            if hl in (b"\r\n", b"\n", b""):
                break
            name, _, value = hl.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        try:
            length = int(headers.get("content-length", 0) or 0)
        except ValueError:
            raise _HTTPError(400, "Content-Length is not an integer",
                             close=True)
        if length < 0:
            raise _HTTPError(400, "negative Content-Length", close=True)
        if length > self.max_body_bytes:
            # the body is not going to be read: the connection cannot be
            # resynced, so this response must be the connection's last
            raise _HTTPError(400, f"body too large ({length} bytes)",
                             close=True)
        body = await reader.readexactly(length) if length else b""
        path, _, query = path.partition("?")
        return SimpleNamespace(method=method.upper(), path=path,
                               query=query, headers=headers, body=body)

    async def _write_response(self, writer, status: int, payload: dict,
                              headers=()):
        body = json.dumps(payload).encode()
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
                f"Server: {_SERVER}",
                "Content-Type: application/json",
                f"Content-Length: {len(body)}"]
        head += [f"{k}: {v}" for k, v in headers]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()
        self._m.responses.labels(code=str(status)).inc()

    # -- routing -----------------------------------------------------------
    async def _handle(self, req, writer) -> bool:
        """Serve one request; returns True to keep the connection alive."""
        t0 = time.monotonic()
        route = f"{req.method} {req.path}"
        self._m.requests.labels(route=route).inc()
        try:
            faults.inject("gateway.request", route=route)
            if req.path == "/healthz":
                return await self._route_healthz(writer)
            if req.path == "/metrics":
                return await self._route_metrics(writer)
            if req.path == "/stats":
                doc = self.router.stats()
                doc["gateway"] = self.gateway_stats()
                # fleet-facing tenancy view: registry config + admission
                # decisions; the per-engine "tenancy" blocks (cost, SLO)
                # ride inside each replica's stats under doc["replicas"]
                doc["tenancy"] = self.tenancy.snapshot()
                if self.autoscaler is not None:
                    doc["autoscaler"] = self.autoscaler.stats()
                if self.remediation is not None:
                    doc["remediation"] = self.remediation.stats()
                if self._rollout is not None:
                    doc["rollout"] = self._rollout.doc()
                await self._write_response(writer, 200, doc)
                return True
            if req.path == "/v1/models":
                await self._write_response(writer, 200, {
                    "object": "list",
                    "data": [{"id": self.model_name, "object": "model",
                              "owned_by": "paddle_tpu"}]})
                return True
            if req.path in ("/v1/completions", "/v1/chat/completions"):
                if req.method != "POST":
                    raise _HTTPError(405, "POST only")
                return await self._route_completions(
                    req, writer, chat=req.path.endswith("chat/completions"))
            if req.path.startswith("/v1/streams/"):
                return await self._route_stream_resume(req, writer)
            if req.path.startswith("/v1/traces/"):
                return await self._route_trace(req, writer)
            if req.path == "/v1/alerts":
                return await self._route_alerts(writer)
            if req.path == "/v1/history":
                return await self._route_history(req, writer)
            if req.path == "/v1/profile":
                return await self._route_profile(req, writer)
            if req.path == "/v1/dashboard":
                return await self._route_dashboard(writer)
            if req.path.startswith("/v1/admin/"):
                return await self._route_admin(req, writer)
            raise _HTTPError(404, f"no route {req.path}")
        except _HTTPError as e:
            await self._write_response(
                writer, e.status, {"error": {"message": str(e),
                                             "type": e.err_type or
                                             ("invalid_request_error"
                                              if e.status < 500 else
                                              "server_error")}},
                headers=e.headers)
            return e.status < 500 and not e.close
        except RouterShed as e:
            self._m.shed.inc()
            if e.tenant is not None:
                # the tenant's own bucket shed this — count it against the
                # tenant, and the Retry-After below is its refill horizon
                self._m.tenant_shed.labels(tenant=e.tenant).inc()
            retry = max(1, math.ceil(e.retry_after_s))
            await self._write_response(
                writer, 429,
                {"error": {"message": str(e), "type": "overloaded_error",
                           "retry_after_s": e.retry_after_s,
                           "tenant": e.tenant}},
                headers=[("Retry-After", str(retry))])
            return True
        except NoHealthyReplica as e:
            await self._write_response(
                writer, 503, {"error": {"message": str(e),
                                        "type": "server_error"}})
            return True
        except JournalError as e:
            # durability could not be promised: refuse rather than accept
            # a request a crash would silently lose
            await self._write_response(
                writer, 500,
                {"error": {"message": f"journal unavailable: {e}",
                           "type": "server_error"}})
            return False
        except Exception as e:
            await self._write_response(
                writer, 500,
                {"error": {"message": f"{type(e).__name__}: {e}",
                           "type": "server_error"}})
            return False
        finally:
            self._m.latency.observe(time.monotonic() - t0)

    def gateway_stats(self) -> dict:
        """The ``gateway`` block of ``GET /stats``."""
        with self._slock:
            retained = len(self._stream_order)
            live = sum(1 for j in self._stream_order
                       if not self._streams[j].terminal)
            idem = len(self._idem)
        return {
            "gateway_id": self.gateway_id,
            "journal": (self.journal.stats()
                        if self.journal is not None else None),
            "recovery": self.recovery_report,
            "streams_retained": retained,
            "streams_live": live,
            "idempotency_keys": idem,
            "ops": {
                "history": (self.history.stats()
                            if self.history is not None else None),
                "alerts": ({"firing": len(self.alerts.firing()),
                            "evaluations": self.alerts.evaluations}
                           if self.alerts is not None else None),
                "profiler": (self.profiler.stats()
                             if self.profiler is not None else None),
            },
        }

    async def _route_admin(self, req, writer) -> bool:
        """The fleet control plane:

        - ``GET  /v1/admin/rollout``  — active rollout state (404: none)
        - ``POST /v1/admin/rollout``  — start a rolling upgrade
          (body: ``{"spec": {...}, "env": {...}, "canary_bake_s": N,
          "dry_run": bool}``); 409 while one is already in flight
        - ``POST /v1/admin/rollback`` — roll the active rollout back
        - ``POST /v1/admin/remediate``— poke the remediation engine:
          optional ``{"alert": {...}}`` runs one synthetic alert through
          the playbooks; ``{"dry_run": bool}`` flips dry-run mode;
          always sweeps bake deadlines and returns the engine stats
        """
        if req.path == "/v1/admin/rollout" and req.method == "GET":
            if self._rollout is None:
                raise _HTTPError(404, "no rollout (active or finished)")
            await self._write_response(writer, 200, self._rollout.doc())
            return True
        if req.method != "POST":
            raise _HTTPError(405, "POST only")
        try:
            body = json.loads(req.body.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise _HTTPError(400, f"body is not JSON: {e}")
        if not isinstance(body, dict):
            raise _HTTPError(400, "body must be a JSON object")
        if req.path == "/v1/admin/rollout":
            if self.rollout_factory is None:
                raise _HTTPError(501, "no rollout_factory wired")
            if self._rollout is not None and \
                    self._rollout.state not in ("done", "rolled_back",
                                                "failed", "idle"):
                raise _HTTPError(
                    409, f"rollout {self._rollout.rollout_id} is "
                         f"{self._rollout.state}")
            spec = body.get("spec")
            if not isinstance(spec, dict):
                raise _HTTPError(400, "body needs a 'spec' object")
            kw = {k: body[k] for k in
                  ("canary_bake_s", "dry_run", "drain_budget_s",
                   "regression_ratio", "min_goodput") if k in body}
            ru = self.rollout_factory(spec, dict(body.get("env") or {}),
                                      **kw)
            self._rollout = ru
            ru.start()
            # rollouts run minutes; drive them off-thread and let
            # /v1/admin/rollout (or /stats) report progress
            self._rollout_thread = threading.Thread(
                target=ru.run, name="gateway-rollout", daemon=True)
            self._rollout_thread.start()
            await self._write_response(writer, 202, ru.doc())
            return True
        if req.path == "/v1/admin/rollback":
            if self._rollout is None:
                raise _HTTPError(404, "no rollout to roll back")
            doc = self._rollout.rollback(
                reason=str(body.get("reason") or "operator"))
            await self._write_response(writer, 200, doc)
            return True
        if req.path == "/v1/admin/remediate":
            if self.remediation is None:
                raise _HTTPError(501, "no remediation engine wired")
            if "dry_run" in body:
                self.remediation.dry_run = bool(body["dry_run"])
            if isinstance(body.get("alert"), dict):
                self.remediation.consider(body["alert"])
            self.remediation.check_bakes()
            await self._write_response(
                writer, 200, self.remediation.stats())
            return True
        raise _HTTPError(404, f"no admin route {req.path}")

    async def _route_healthz(self, writer) -> bool:
        st = self.router.stats()
        healthy = st["healthy"] > 0
        await self._write_response(
            writer, 200 if healthy else 503,
            {"status": "ok" if healthy else "no healthy replica",
             "healthy_replicas": st["healthy"],
             "replicas": {r: v["state"] for r, v in st["replicas"].items()},
             "inflight": st["inflight"]})
        return True

    async def _route_trace(self, req, writer) -> bool:
        """``GET /v1/traces/<id>``: the merged per-request Chrome trace
        (id = completion id ``cmpl-<gid>``, a raw gid, or the ``trace_id``
        the response's ``paddle_tpu`` block carried), one row per
        process the request ran in."""
        key = req.path.rsplit("/", 1)[1]
        try:
            doc = self.router.request_trace(key)
        except KeyError:
            raise _HTTPError(404, f"no request trace for {key!r} (traces "
                                  "are retained for recent requests only)")
        await self._write_response(writer, 200, doc)
        return True

    async def _route_metrics(self, writer) -> bool:
        body = telemetry.prometheus_text().encode()
        head = (f"HTTP/1.1 200 OK\r\nServer: {_SERVER}\r\n"
                f"Content-Type: text/plain; version=0.0.4\r\n"
                f"Content-Length: {len(body)}\r\n\r\n")
        writer.write(head.encode() + body)
        await writer.drain()
        self._m.responses.labels(code="200").inc()
        return True

    # -- the ops plane (history / alerts / profiler / dashboard) -----------
    async def _write_raw(self, writer, body: bytes, content_type: str,
                         status: int = 200) -> bool:
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
                f"Server: {_SERVER}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n\r\n")
        writer.write(head.encode() + body)
        await writer.drain()
        self._m.responses.labels(code=str(status)).inc()
        return True

    @staticmethod
    def _query_params(req) -> dict:
        out = {}
        for part in (req.query or "").split("&"):
            if not part:
                continue
            k, _, v = part.partition("=")
            out[urllib.parse.unquote(k)] = urllib.parse.unquote(v)
        return out

    async def _route_alerts(self, writer) -> bool:
        """``GET /v1/alerts``: the alert engine's full state — firing /
        pending alerts, recent resolutions, and the rule pack."""
        if self.alerts is None:
            await self._write_response(
                writer, 200, {"enabled": False, "alerts": [], "rules": [],
                              "firing": 0, "pending": 0})
            return True
        doc = self.alerts.state()
        doc["enabled"] = True
        await self._write_response(writer, 200, doc)
        return True

    async def _route_history(self, req, writer) -> bool:
        """``GET /v1/history``: no params lists families; ``?family=X
        [&window=SEC][&res=raw|10s|1m][&label.<k>=<v>]`` returns points
        (counters as rates, histograms as quantile summaries)."""
        if self.history is None:
            await self._write_response(
                writer, 200, {"enabled": False, "families": []})
            return True
        params = self._query_params(req)
        family = params.get("family")
        if not family:
            await self._write_response(writer, 200, {
                "enabled": True,
                "families": self.history.families(),
                "stats": self.history.stats()})
            return True
        labels = {k[len("label."):]: v for k, v in params.items()
                  if k.startswith("label.")}
        window = params.get("window")
        res = params.get("res", "raw")
        try:
            doc = self.history.query(
                family, labels=labels or None,
                window_s=float(window) if window else None, res=res)
        except ValueError as e:
            raise _HTTPError(400, str(e))
        doc["enabled"] = True
        await self._write_response(writer, 200, doc)
        return True

    async def _route_profile(self, req, writer) -> bool:
        """``GET /v1/profile``: this process's continuous profile —
        speedscope JSON by default, ``?format=folded`` for flamegraph
        lines, ``?format=stats`` for the sampler's own counters."""
        if self.profiler is None:
            await self._write_response(
                writer, 200, {"enabled": False})
            return True
        fmt = self._query_params(req).get("format", "speedscope")
        if fmt == "folded":
            return await self._write_raw(
                writer, (self.profiler.folded() + "\n").encode(),
                "text/plain; charset=utf-8")
        if fmt == "stats":
            await self._write_response(
                writer, 200, {"enabled": True, **self.profiler.stats()})
            return True
        doc = self.profiler.speedscope(name=self.gateway_id)
        doc["enabled"] = True
        await self._write_response(writer, 200, doc)
        return True

    async def _route_dashboard(self, writer) -> bool:
        """``GET /v1/dashboard``: a dependency-free HTML ops page —
        alerts table, history sparklines, profiler top stacks — polling
        the JSON endpoints above from inline JS."""
        html = _DASHBOARD_HTML.replace("__GATEWAY_ID__", self.gateway_id)
        return await self._write_raw(writer, html.encode(),
                                     "text/html; charset=utf-8")

    # -- completions -------------------------------------------------------
    def _resolve_tenant(self, req) -> str:
        """``Authorization`` header -> tenant name, or 401.

        The documented 401 body shape is
        ``{"error": {"message": ..., "type": "authentication_error"}}``
        with a ``WWW-Authenticate: Bearer`` header. The ``gateway.auth``
        fault site fails **closed**: an injected auth-backend error denies
        the request (401) rather than admitting it as anonymous."""
        try:
            faults.inject("gateway.auth")
            return self.tenancy.resolve(req.headers.get("authorization"))
        except AuthError as e:
            self._m.auth_failures.inc()
            raise _HTTPError(401, str(e),
                             headers=[("WWW-Authenticate", "Bearer")],
                             err_type="authentication_error")
        except Exception as e:
            self._m.auth_failures.inc()
            raise _HTTPError(401,
                            f"auth unavailable: {type(e).__name__}: {e}",
                            headers=[("WWW-Authenticate", "Bearer")],
                            err_type="authentication_error")

    def _parse_body(self, req, chat: bool) -> dict:
        try:
            doc = json.loads(req.body.decode() or "{}")
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise _HTTPError(400, f"body is not JSON: {e}")
        if not isinstance(doc, dict):
            raise _HTTPError(400, "body must be a JSON object")
        try:
            if chat:
                msgs = doc.get("messages")
                if not isinstance(msgs, list) or not msgs:
                    raise ValueError("chat needs a non-empty messages list")
                prompt = []
                for i, m in enumerate(msgs):
                    prompt += _parse_tokens(
                        (m or {}).get("content", []),
                        f"messages[{i}].content")
            else:
                prompt = _parse_tokens(doc.get("prompt", []), "prompt")
            if not prompt:
                raise ValueError("empty prompt")
        except ValueError as e:
            raise _HTTPError(400, str(e))
        deadline_ms = doc.get("deadline_ms",
                              req.headers.get("x-deadline-ms"))
        deadline_s = (float(deadline_ms) / 1e3 if deadline_ms is not None
                      else self.default_deadline_s)
        sampling = {
            "max_new_tokens": int(doc.get("max_tokens", 16)),
            "temperature": float(doc.get("temperature", 0.0)),
            "top_k": int(doc.get("top_k", 0)),
            "top_p": float(doc.get("top_p", 1.0)),
            "seed": int(doc.get("seed", 0)),
        }
        return {"prompt": prompt, "sampling": sampling,
                "stream": bool(doc.get("stream", False)),
                "priority": int(doc.get("priority", 0)),
                "deadline_s": deadline_s}

    @staticmethod
    def _last_event_id(req) -> int:
        """The resume watermark: ``Last-Event-ID`` header (SSE standard)
        or a ``from=`` query parameter; 0 = from the beginning."""
        v = req.headers.get("last-event-id")
        if v is None and req.query:
            for part in req.query.split("&"):
                k, _, val = part.partition("=")
                if k == "from":
                    v = val
        try:
            return max(0, int(v)) if v is not None else 0
        except ValueError:
            raise _HTTPError(400, f"bad Last-Event-ID {v!r}")

    async def _route_completions(self, req, writer, chat: bool) -> bool:
        tenant = self._resolve_tenant(req)          # 401 before parsing
        p = self._parse_body(req, chat)
        p["tenant"] = tenant
        # per-tenant token bucket: the admission charge is the worst-case
        # tokens this request occupies the engine for (prompt + output
        # budget, the same cost the scheduler's DRR uses). A bucket shed
        # carries the *tenant's own* refill horizon as Retry-After, not
        # the fleet-wide Little's-law estimate.
        cost = len(p["prompt"]) + p["sampling"]["max_new_tokens"]
        retry = self.tenancy.admit(tenant, cost)
        if retry is not None:
            raise RouterShed(
                f"tenant {tenant!r} over its rate limit "
                f"({cost} tokens requested)",
                retry_after_s=retry, tenant=tenant)
        idem = req.headers.get("idempotency-key")
        t_req0 = time.monotonic()
        st, fresh = self._accept(p, chat, idem)
        if not fresh:
            # a client retry of a request this gateway (or, via the
            # journal, a previous incarnation) already accepted:
            # exactly-once semantics — attach or replay, never re-run
            self._m.idem_hits.labels(
                outcome="replay" if st.terminal else "attach").inc()
            if p["stream"]:
                self._m.resumes.inc()
                return await self._stream_from(writer, st,
                                               self._last_event_id(req))
            return await self._respond_when_done(writer, st)
        try:
            if p["stream"]:
                return await self._stream_from(writer, st, 0)
            return await self._respond_when_done(writer, st)
        finally:
            telemetry.tracer().emit(
                "gateway.request", t_req0, time.monotonic(),
                attrs={"trace_id": st.jid,
                       "gid": st.rr.gid if st.rr is not None else None,
                       "route": "chat" if chat else "completions",
                       "stream": p["stream"], "tokens": len(st.tokens)})

    async def _route_stream_resume(self, req, writer) -> bool:
        """``GET /v1/streams/<id>``: (re-)attach to a stream by trace id
        or completion id, from the ``Last-Event-ID`` watermark (or
        ``?from=N``). Running streams continue live; terminal ones replay
        their recorded suffix. The resume contract: the client receives
        exactly the tokens it has not seen — no duplicates, no gaps."""
        key = req.path.rsplit("/", 1)[1]
        st = self._find_stream(key)
        if st is None:
            raise _HTTPError(404, f"no stream {key!r} (streams are "
                                  "retained for recent requests only)")
        from_idx = self._last_event_id(req)
        self._m.resumes.inc()
        return await self._stream_from(writer, st, from_idx)

    # -- responses ---------------------------------------------------------
    def _completion_doc(self, st: _Stream) -> tuple[int, dict]:
        """(status, body) for a terminal stream — built purely from the
        stream snapshot so live responses and idempotent replays are
        byte-identical."""
        if st.state == "failed":
            return 500, {"error": {"message": st.error or "request failed",
                                   "type": "server_error",
                                   "finish_reason": st.finish_reason}}
        text = " ".join(str(t) for t in st.tokens)
        finish = (st.finish_reason if st.state == "finished"
                  else (st.finish_reason or "cancelled"))
        if st.chat:
            choice = {"index": 0,
                      "message": {"role": "assistant", "content": text},
                      "token_ids": list(st.tokens), "finish_reason": finish}
            obj = "chat.completion"
        else:
            choice = {"index": 0, "text": text,
                      "token_ids": list(st.tokens), "finish_reason": finish}
            obj = "text_completion"
        return 200, {
            "id": st.rid, "object": obj, "created": st.created,
            "model": self.model_name, "choices": [choice],
            "usage": {"prompt_tokens": st.prompt_len,
                      "completion_tokens": len(st.tokens),
                      "total_tokens": st.prompt_len + len(st.tokens)},
            "paddle_tpu": {"replica": st.replica,
                           "failovers": st.failovers,
                           "retries": st.retries,
                           "trace_id": st.jid}}

    async def _respond_when_done(self, writer, st: _Stream) -> bool:
        """Non-streaming: wait for the terminal state, answer once."""
        q, _, terminal = self._subscribe(st, len(st.tokens))
        try:
            while not terminal and not st.done.is_set():
                kind, _, _ = await q.get()
                if kind == "done":
                    break
        finally:
            self._unsubscribe(st, q)
        status, doc = self._completion_doc(st)
        if status == 200:
            self._m.tokens.inc(len(st.tokens))
        await self._write_response(writer, status, doc)
        return True

    def _sse_chunk(self, st: _Stream, tok=None, event_id=None,
                   finish=None, error=None, extra=None) -> bytes:
        obj = ("chat.completion.chunk" if st.chat
               else "text_completion.chunk")
        if st.chat:
            delta = {"content": f"{tok} "} if tok is not None else {}
            c = {"index": 0, "delta": delta, "finish_reason": finish}
        else:
            c = {"index": 0, "text": f"{tok} " if tok is not None else "",
                 "finish_reason": finish}
        if tok is not None:
            c["token_ids"] = [tok]
        doc = {"id": st.rid, "object": obj, "model": self.model_name,
               "choices": [c]}
        if error is not None:
            doc["error"] = {"message": error, "type": "server_error"}
        if extra:
            doc.update(extra)
        frame = b""
        if event_id is not None:
            # the resume watermark: a client that reconnects with
            # Last-Event-ID: <n> resumes after its n-th token
            frame += f"id: {event_id}\n".encode()
        frame += f"data: {json.dumps(doc)}\n\n".encode()
        return frame

    async def _stream_from(self, writer, st: _Stream, from_idx: int) -> bool:
        """SSE from token index ``from_idx``: replay the retained suffix,
        then follow live; failover is invisible (the router only forwards
        post-suppression tokens) and a disconnect leaves the request
        running for the next resume (unless ``cancel_on_disconnect``)."""
        head = (f"HTTP/1.1 200 OK\r\nServer: {_SERVER}\r\n"
                "Content-Type: text/event-stream\r\n"
                "Cache-Control: no-cache\r\nConnection: close\r\n\r\n")
        writer.write(head.encode())
        await writer.drain()
        self._m.responses.labels(code="200").inc()
        self._m.active.inc()
        q, snapshot, terminal = self._subscribe(st, from_idx)
        idx = from_idx
        t_first = None
        disconnected = False
        try:
            for tok in snapshot:
                if t_first is None:
                    t_first = time.monotonic()
                writer.write(self._sse_chunk(st, tok=tok, event_id=idx + 1))
                idx += 1
                self._m.tokens.inc()
            await writer.drain()
            if not terminal:
                while True:
                    kind, i, tok = await q.get()
                    if kind == "done":
                        break
                    if i < idx:
                        continue           # already covered by the snapshot
                    if t_first is None:
                        t_first = time.monotonic()
                    writer.write(self._sse_chunk(st, tok=tok,
                                                 event_id=i + 1))
                    idx = i + 1
                    self._m.tokens.inc()
                    await writer.drain()
            finish = st.finish_reason or st.state
            final = self._sse_chunk(
                st, finish=finish,
                error=st.error if st.state == "failed" else None,
                extra={"paddle_tpu": {"trace_id": st.jid,
                                      "replica": st.replica,
                                      "failovers": st.failovers}})
            writer.write(final)
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            disconnected = True
            if self.cancel_on_disconnect and not st.terminal \
                    and st.rr is not None:
                # old stateless behavior: client gone => release the work
                self.router.cancel(st.rr.gid)
            # durable behavior: detach only — the decode keeps running and
            # the journal keeps filling, so a reconnect picks up the tail
        finally:
            self._unsubscribe(st, q)
            self._m.active.dec()
            if t_first is not None:
                telemetry.tracer().emit(
                    "gateway.sse", t_first, time.monotonic(),
                    attrs={"trace_id": st.jid,
                           "gid": st.rr.gid if st.rr is not None else None,
                           "tokens": idx - from_idx,
                           "resumed_from": from_idx,
                           "disconnected": disconnected})
        return False                        # Connection: close
