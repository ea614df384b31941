"""Node web dashboard.

Parity surface: reference ``apps/node/src/app/{templates/index.html,
static/js/main.js}`` — a landing page that fetches
``/data-centric/detailed-models-list/`` and renders the hosted models.
Here it is one self-contained page (no static asset tree) that also shows
node identity/status, so a browser hitting the node root sees the grid
state. All dynamic values — the node id and every model field — render
through HTML escaping / ``textContent``, never markup interpolation: a
hosted model id is client-supplied data and must not execute in the
operator's browser. The port's copy of :mod:`pygrid_tpu.node.dashboard`.
"""

from __future__ import annotations

import html

PAGE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>pygrid-tpu node — {node_id}</title>
<style>
  body {{ font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 52rem;
         color: #1a1a1a; }}
  h1 {{ font-size: 1.4rem; }} code {{ background: #f4f4f4; padding: .1em .3em; }}
  table {{ border-collapse: collapse; width: 100%; margin-top: 1rem; }}
  th, td {{ text-align: left; padding: .4rem .6rem; border-bottom: 1px solid #ddd; }}
  .muted {{ color: #777; }}
</style>
</head>
<body>
<h1>pygrid-tpu node <code>{node_id}</code></h1>
<p class="muted" id="status">loading status…</p>
<h2>FL processes</h2>
<table id="fl"><thead>
<tr><th>name</th><th>version</th><th>cycles</th><th>latest loss</th>
<th>latest acc</th></tr>
</thead><tbody></tbody></table>
<h2>Hosted models</h2>
<table id="models"><thead>
<tr><th>id</th><th>download</th><th>remote inference</th><th>mpc</th></tr>
</thead><tbody></tbody></table>
<h2>Recent cycles</h2>
<table id="cycles"><thead>
<tr><th>cycle</th><th>seq</th><th>reports</th><th>stragglers</th>
<th>aggregate (ms)</th><th>outcome</th></tr>
</thead><tbody></tbody></table>
<h2>Generation serving</h2>
<table id="serving"><thead>
<tr><th>model</th><th>queue</th><th>slots live</th><th>requests</th>
<th>tokens</th><th>compiles</th></tr>
</thead><tbody></tbody></table>
<h2>SLOs</h2>
<table id="slo"><thead>
<tr><th>objective</th><th>target</th><th>events</th><th>compliance</th>
<th>burn (short)</th><th>burn (long)</th><th>status</th></tr>
</thead><tbody></tbody></table>
<script>
function row(fields) {{
  const tr = document.createElement('tr');
  for (const value of fields) {{
    const td = document.createElement('td');
    td.textContent = String(value);  // data, never markup
    tr.appendChild(td);
  }}
  return tr;
}}
async function refresh() {{
  try {{
    const st = await (await fetch('/data-centric/status/')).json();
    document.getElementById('status').textContent =
      'status: ' + (st.status || JSON.stringify(st));
    const res = await (await fetch('/data-centric/detailed-models-list/')).json();
    const tbody = document.querySelector('#models tbody');
    tbody.replaceChildren();
    const models = res.models || [];
    if (!models.length) {{
      const tr = document.createElement('tr');
      const td = document.createElement('td');
      td.colSpan = 4; td.className = 'muted'; td.textContent = 'none';
      tr.appendChild(td); tbody.appendChild(tr);
    }}
    for (const m of models) {{
      tbody.appendChild(
        row([m.id, m.allow_download, m.allow_remote_inference, m.mpc]));
    }}
    const fl = await (await fetch('/model-centric/processes')).json();
    const flBody = document.querySelector('#fl tbody');
    flBody.replaceChildren();
    const procs = fl.processes || [];
    if (!procs.length) {{
      const tr = document.createElement('tr');
      const td = document.createElement('td');
      td.colSpan = 5; td.className = 'muted'; td.textContent = 'none';
      tr.appendChild(td); flBody.appendChild(tr);
    }}
    for (const p of procs) {{
      const m = p.latest_metrics || {{}};
      flBody.appendChild(row([
        p.name, p.version,
        p.cycles_completed + '/' + p.cycles_total,
        'loss' in m ? m.loss.toFixed(4) : '—',
        'acc' in m ? m.acc.toFixed(4) : '—']));
    }}
    const tl = await (await fetch('/telemetry/cycles')).json();
    const cyBody = document.querySelector('#cycles tbody');
    cyBody.replaceChildren();
    const cycles = tl.cycles || [];
    if (!cycles.length) {{
      const tr = document.createElement('tr');
      const td = document.createElement('td');
      td.colSpan = 6; td.className = 'muted'; td.textContent = 'none';
      tr.appendChild(td); cyBody.appendChild(tr);
    }}
    for (const c of cycles) {{
      const agg = (c.phases || {{}}).aggregate;
      cyBody.appendChild(row([
        c.cycle_id, c.sequence ?? '—',
        c.reported + '/' + c.assigned,
        c.stragglers ?? '—',
        agg !== undefined ? (agg * 1000).toFixed(1) : '—',
        c.outcome || 'open']));
    }}
    const sv = await (await fetch('/telemetry/serving')).json();
    const svBody = document.querySelector('#serving tbody');
    svBody.replaceChildren();
    const engines = sv.engines || [];
    if (!engines.length) {{
      const tr = document.createElement('tr');
      const td = document.createElement('td');
      td.colSpan = 6; td.className = 'muted'; td.textContent = 'none';
      tr.appendChild(td); svBody.appendChild(tr);
    }}
    for (const e of engines) {{
      svBody.appendChild(row([
        e.model_id, e.queue_depth,
        e.live_slots + '/' + e.max_slots,
        e.requests_total, e.tokens_total, e.compiles_total]));
    }}
    const slo = await (await fetch('/telemetry/slo')).json();
    const sloBody = document.querySelector('#slo tbody');
    sloBody.replaceChildren();
    const objectives = slo.slo || [];
    if (!objectives.length) {{
      const tr = document.createElement('tr');
      const td = document.createElement('td');
      td.colSpan = 7; td.className = 'muted'; td.textContent = 'none';
      tr.appendChild(td); sloBody.appendChild(tr);
    }}
    for (const o of objectives) {{
      const burns = Object.values(o.burn || {{}});
      const fmt = (v) => v === null || v === undefined
        ? '—' : Number(v).toFixed(2);
      sloBody.appendChild(row([
        o.name, o.target, o.events,
        o.compliance === null ? '—' : (o.compliance * 100).toFixed(1) + '%',
        fmt(burns[0]), fmt(burns[1]), o.status]));
    }}
  }} catch (err) {{
    document.getElementById('status').textContent = 'error: ' + err;
  }}
}}
refresh(); setInterval(refresh, 5000);
</script>
</body>
</html>
"""


def render(node_id: str) -> str:
    return PAGE.format(node_id=html.escape(str(node_id), quote=True))
