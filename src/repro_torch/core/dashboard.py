"""Zero-dependency live dashboard (DESIGN.md §17), the port's copy.

A stdlib ``http.server`` serving the three views dask's monitors proved
out — task-stream timeline, per-node memory-vs-budget gauges, node×node
transfer matrix — as one embedded HTML page polling JSON endpoints:

* ``/api/status``    — runtime identity, task counters, per-node
  heartbeat view (memory, occupancy, in-flight depth)
* ``/api/tasks``     — task-lifecycle ring events (``?since=<seq>`` for
  incremental polling, ``?limit=<n>`` to cap)
* ``/api/transfers`` — node×node byte matrix from the §15 p2p ledger
* ``/api/trace``     — the full Chrome-trace JSON (open in Perfetto)

Enable with ``runtime_start(dashboard_port=8787)`` (0 = ephemeral port)
or ``RJAX_DASHBOARD=8787``.  The server runs a daemon thread pool and
never blocks the scheduler: every endpoint renders from the telemetry
hub's lock-guarded snapshots.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>rjax dashboard</title>
<style>
 body{background:#14161a;color:#d8dde3;font:13px/1.45 system-ui,sans-serif;
      margin:0;padding:16px}
 h1{font-size:16px;margin:0 0 4px} h2{font-size:13px;color:#8b97a5;
      margin:18px 0 6px;text-transform:uppercase;letter-spacing:.06em}
 .meta{color:#8b97a5} .cards{display:flex;gap:10px;flex-wrap:wrap}
 .card{background:#1d2127;border:1px solid #2a2f37;border-radius:6px;
      padding:8px 12px;min-width:130px}
 .card .v{font-size:18px;color:#e8eef4} .card .k{color:#8b97a5;font-size:11px}
 canvas{background:#1d2127;border:1px solid #2a2f37;border-radius:6px;
      width:100%;height:220px;display:block}
 table{border-collapse:collapse} td,th{border:1px solid #2a2f37;
      padding:3px 9px;text-align:right} th{color:#8b97a5;font-weight:normal}
 .bar{background:#2a2f37;border-radius:3px;height:10px;width:180px;
      display:inline-block;vertical-align:middle;overflow:hidden}
 .bar i{display:block;height:100%;background:#4e9af1}
 .bar i.hot{background:#e06c5a}
 .ok{color:#6fc17a}.bad{color:#e06c5a}
</style></head><body>
<h1>rjax <span id="backend"></span> <span class="meta" id="ident"></span></h1>
<div class="meta" id="counters"></div>
<h2>Task stream</h2><canvas id="stream" width="1200" height="220"></canvas>
<div class="meta" id="streamlegend"></div>
<h2>Nodes</h2><div id="nodes"></div>
<h2>Transfer matrix (bytes)</h2><div id="transfers"></div>
<script>
const colors={}, palette=['#4e9af1','#6fc17a','#e0b05a','#b87ae0','#5ad0c8',
 '#e06c5a','#9aa9ff','#cddc6f'];
let nc=0;
function color(n){if(!(n in colors))colors[n]=palette[nc++%palette.length];
 return colors[n];}
let events=[], lastSeq=0;
function fmtB(b){if(b>1<<30)return (b/(1<<30)).toFixed(2)+' GiB';
 if(b>1<<20)return (b/(1<<20)).toFixed(1)+' MiB';
 if(b>1024)return (b/1024).toFixed(1)+' KiB';return b+' B';}
async function poll(){
 try{
  const st=await (await fetch('api/status')).json();
  document.getElementById('backend').textContent=st.backend;
  document.getElementById('ident').textContent=
   st.name+' · '+st.n_workers+' workers · up '+st.uptime_s.toFixed(0)+'s';
  const c=st.tasks||{};
  document.getElementById('counters').innerHTML=
   'tasks: <b>'+(c.done||0)+'</b> done · '+(c.running||0)+' running · '+
   (c.ready||0)+' ready · '+(c.waiting||0)+' waiting · '+
   '<span class="'+((c.failed||0)?'bad':'ok')+'">'+(c.failed||0)+
   ' failed</span> · queue '+st.queue_len+' · ring '+st.ring.size+'/'+
   st.ring.capacity+(st.ring.dropped?' ('+st.ring.dropped+' dropped)':'');
  renderNodes(st);
  const tk=await (await fetch('api/tasks?since='+lastSeq)).json();
  if(tk.events.length){events.push(...tk.events);lastSeq=tk.last_seq;
   if(events.length>4096)events=events.slice(-4096);}
  renderStream(tk.now);
  const tr=await (await fetch('api/transfers')).json();
  renderTransfers(tr);
 }catch(e){}
 setTimeout(poll,1000);
}
function renderStream(now){
 const cv=document.getElementById('stream'),g=cv.getContext('2d');
 g.clearRect(0,0,cv.width,cv.height);
 const done=events.filter(e=>e.kind=='done'||e.kind=='fail'||e.kind=='retry');
 if(!done.length)return;
 const span=15, t1=now, t0=t1-span;
 const lanes=[...new Set(done.map(e=>e.node+'/'+e.worker))].sort();
 const lh=Math.min(24,Math.max(6,(cv.height-16)/Math.max(1,lanes.length)));
 const names=new Set();
 g.font='10px sans-serif';
 lanes.forEach((ln,i)=>{g.fillStyle='#566070';
  g.fillText(ln,2,14+i*lh+lh*0.7);});
 for(const e of done){
  if(e.t1<t0)continue;
  const i=lanes.indexOf(e.node+'/'+e.worker);
  const x0=Math.max(0,(Math.max(e.t_run||e.t0,t0)-t0)/span*cv.width);
  const x1=Math.min(cv.width,(e.t1-t0)/span*cv.width);
  g.fillStyle=e.kind=='done'?color(e.name):'#e06c5a';
  g.fillRect(x0,16+i*lh,Math.max(1.5,x1-x0),lh-2);
  if(e.t_run&&e.t_run>e.t0){ // fetch/stall gap rendered dimmer
   const s0=Math.max(0,(Math.max(e.t0,t0)-t0)/span*cv.width);
   g.globalAlpha=0.25;g.fillRect(s0,16+i*lh,Math.max(1,x0-s0),lh-2);
   g.globalAlpha=1;}
  names.add(e.name);}
 document.getElementById('streamlegend').innerHTML='last '+span+'s · '+
  [...names].map(n=>'<span style="color:'+color(n)+'">■</span> '+n).join('  ');
}
function renderNodes(st){
 let h='<table><tr><th>node</th><th>state</th><th>heartbeats</th><th>age</th>'+
  '<th>in-flight</th><th>queued</th><th>memory</th><th>spills</th>'+
  '<th>p2p fetches</th><th>replicas</th></tr>';
 for(const [nid,n] of Object.entries(st.nodes)){
  const used=n.plane_bytes_used??n.plane_bytes??n.store_bytes_used??0;
  const budget=n.plane_budget_bytes??n.store_budget_bytes??0;
  const pct=budget?Math.min(100,100*used/budget):0;
  const sc={alive:'#5ad18b',suspect:'#e0b25a',dead:'#e06c5a',
   respawning:'#e0b25a',disconnected:'#e0b25a',
   reconnecting:'#4e9af1'}[n.state]||'#888';
  const state=n.state?'<span style="color:'+sc+'">'+n.state+'</span>'+
   (n.beat_age_s!=null?' <span class="meta">'+n.beat_age_s.toFixed(1)+
   's</span>':''):'-';
  h+='<tr><td>'+nid+'</td><td>'+state+'</td><td>'+n.heartbeats+'</td><td>'+
   (n.age_s!=null?n.age_s.toFixed(1)+'s':'-')+'</td><td>'+(n.inflight||0)+'</td><td>'+
   (n.queued??'-')+'</td><td><span class="bar"><i class="'+
   (pct>85?'hot':'')+'" style="width:'+pct+'%"></i></span> '+
   fmtB(used)+(budget?' / '+fmtB(budget):'')+'</td><td>'+
   (n.plane_spills??n.store_spills??0)+'</td><td>'+(n.p2p_fetches??0)+
   '</td><td>'+(n.replicas??0)+'</td></tr>';}
 document.getElementById('nodes').innerHTML=h+'</table>';
}
function renderTransfers(tr){
 const m=tr.matrix||[];
 if(!m.length){document.getElementById('transfers').innerHTML=
  '<span class="meta">no transfers yet</span>';return;}
 const ns=[...new Set(m.flatMap(e=>[e.src,e.dst]))].sort((a,b)=>a-b);
 const by={};m.forEach(e=>by[e.src+','+e.dst]=e.bytes);
 const mx=Math.max(...m.map(e=>e.bytes));
 let h='<table><tr><th>src\\\\dst</th>'+
  ns.map(n=>'<th>'+(n<0?'sched':n)+'</th>').join('')+'</tr>';
 for(const s of ns){h+='<tr><th>'+(s<0?'sched':s)+'</th>';
  for(const d of ns){const b=by[s+','+d]||0;
   const a=b?0.15+0.85*b/mx:0;
   h+='<td style="background:rgba(78,154,241,'+a.toFixed(2)+')">'+
    (b?fmtB(b):'·')+'</td>';}
  h+='</tr>';}
 h+='</table><div class="meta">p2p '+fmtB(tr.p2p_bytes)+
  ' · scheduler relay '+fmtB(tr.scheduler_relay_bytes)+'</div>';
 document.getElementById('transfers').innerHTML=h;
}
poll();
</script></body></html>
"""


class DashboardServer:
    """Serve the live dashboard for one runtime on ``host:port``.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).
    All state comes from the runtime's :class:`TelemetryHub` snapshots,
    so requests never touch scheduler locks."""

    def __init__(self, runtime, port: int = 0, host: str = "127.0.0.1"):
        self.runtime = runtime
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # keep the terminal quiet
                pass

            def do_GET(self):
                try:
                    outer._route(self)
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"{runtime.name}-dashboard")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def _route(self, handler) -> None:
        parsed = urlparse(handler.path)
        path = parsed.path.rstrip("/") or "/"
        rt, hub = self.runtime, self.runtime.telemetry
        if path == "/":
            body = _PAGE.encode()
            ctype = "text/html; charset=utf-8"
        elif path == "/api/status":
            body = self._json(hub.snapshot_status(rt))
            ctype = "application/json"
        elif path == "/api/tasks":
            q = parse_qs(parsed.query)
            since = int(q.get("since", ["0"])[0] or 0)
            limit = q.get("limit")
            limit = int(limit[0]) if limit else None
            body = self._json(hub.snapshot_tasks(rt, since=since, limit=limit))
            ctype = "application/json"
        elif path == "/api/transfers":
            body = self._json(hub.snapshot_transfers(rt))
            ctype = "application/json"
        elif path == "/api/trace":
            body = rt.tracer.to_chrome_trace().encode()
            ctype = "application/json"
        else:
            handler.send_response(404)
            handler.send_header("Content-Length", "0")
            handler.end_headers()
            return
        handler.send_response(200)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    @staticmethod
    def _json(obj) -> bytes:
        return json.dumps(obj, default=str).encode()

    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
