"""Web UI (ref ui/: the reference ships an Ember SPA at /ui/; this is a
single-file SPA over the same /v1/* API — jobs, nodes, allocations and
evaluations with drill-down, auto-refresh, and ACL token support, plus the
operational surfaces: job submit with plan-diff preview (ref ui job-run
routes), an allocation filesystem browser (ref ui fs routes), and an
interactive exec terminal over the exec websocket (ref ui exec routes)."""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>nomad-tpu</title>
<style>
  :root { --bg:#15181f; --panel:#1d212b; --line:#2a2f3d; --text:#e6e9f0;
          --dim:#8b93a7; --accent:#5b8dee; --ok:#39b37a; --bad:#e35d6a;
          --warn:#d9a23c; }
  * { box-sizing:border-box; }
  body { margin:0; background:var(--bg); color:var(--text);
         font:14px/1.5 system-ui, sans-serif; }
  header { display:flex; align-items:center; gap:1.5rem; padding:.8rem 1.2rem;
           background:var(--panel); border-bottom:1px solid var(--line); }
  header h1 { font-size:1rem; margin:0; color:var(--accent); }
  nav a { color:var(--dim); text-decoration:none; margin-right:1rem;
          padding:.2rem 0; }
  nav a.active { color:var(--text); border-bottom:2px solid var(--accent); }
  header input { background:var(--bg); color:var(--text);
                 border:1px solid var(--line); border-radius:4px;
                 padding:.3rem .5rem; width:16rem; }
  #search { margin-left:auto; width:14rem; }
  .kv { display:grid; grid-template-columns:14rem 1fr; gap:.15rem .8rem;
        background:var(--panel); border:1px solid var(--line);
        border-radius:6px; padding:.8rem 1rem; margin-bottom:1rem; }
  .kv dt { color:var(--dim); } .kv dd { margin:0; }
  .panel { background:var(--panel); border:1px solid var(--line);
           border-radius:6px; padding:.8rem 1rem; margin-bottom:1rem; }
  .spark { vertical-align:middle; margin-right:.6rem; }
  .sparkval { color:var(--dim); font-size:.8rem; margin-right:1.2rem; }
  .actions button { margin-bottom:.6rem; }
  .ok-note { color:var(--ok); } .warn-note { color:var(--warn); }
  main { padding:1rem 1.2rem; }
  table { width:100%; border-collapse:collapse; background:var(--panel);
          border:1px solid var(--line); border-radius:6px; overflow:hidden; }
  th, td { text-align:left; padding:.45rem .7rem;
           border-bottom:1px solid var(--line); }
  th { color:var(--dim); font-weight:500; font-size:.8rem;
       text-transform:uppercase; letter-spacing:.04em; }
  tr:last-child td { border-bottom:none; }
  tr.row:hover { background:#232838; cursor:pointer; }
  .status { display:inline-block; padding:0 .5rem; border-radius:99px;
            font-size:.8rem; }
  .s-running, .s-ready, .s-complete, .s-successful
    { background:#173527; color:var(--ok); }
  .s-pending, .s-initializing { background:#39301b; color:var(--warn); }
  .s-dead, .s-failed, .s-down, .s-lost { background:#3a2125; color:var(--bad); }
  pre { background:var(--panel); border:1px solid var(--line);
        border-radius:6px; padding:1rem; overflow:auto; max-height:70vh; }
  .err { color:var(--bad); padding:.6rem 0; }
  .crumb { color:var(--dim); margin-bottom:.8rem; }
  .crumb a { color:var(--accent); text-decoration:none; }
  textarea { width:100%; min-height:16rem; background:var(--panel);
             color:var(--text); border:1px solid var(--line);
             border-radius:6px; padding:.8rem; font:13px/1.5 monospace; }
  button { background:var(--accent); color:#fff; border:none;
           border-radius:4px; padding:.4rem .9rem; cursor:pointer;
           margin-right:.5rem; }
  button.ghost { background:var(--panel); color:var(--text);
                 border:1px solid var(--line); }
  .diff-add { color:var(--ok); } .diff-del { color:var(--bad); }
  .diff-edit { color:var(--warn); }
  #term { background:#0d0f14; border:1px solid var(--line);
          border-radius:6px; padding:.8rem; font:13px/1.45 monospace;
          height:20rem; overflow:auto; white-space:pre-wrap; }
  #termin { width:100%; background:var(--panel); color:var(--text);
            border:1px solid var(--line); border-radius:4px;
            padding:.4rem .6rem; font:13px monospace; margin-top:.4rem; }
  .fspath a { color:var(--accent); text-decoration:none; }
</style>
</head>
<body>
<header>
  <h1>nomad-tpu</h1>
  <nav>
    <a href="#/jobs">Jobs</a>
    <a href="#/nodes">Nodes</a>
    <a href="#/allocations">Allocations</a>
    <a href="#/evaluations">Evaluations</a>
    <a href="#/deployments">Deployments</a>
    <a href="#/services">Services</a>
    <a href="#/servers">Servers</a>
    <a href="#/run">Run</a>
  </nav>
  <input id="search" placeholder="Search… (Enter)"
         onkeydown="if(event.key==='Enter')location.hash='#/search/'+encodeURIComponent(this.value)" />
  <input id="token" placeholder="ACL token (X-Nomad-Token)" />
</header>
<main id="view">Loading…</main>
<script>
const view = document.getElementById('view');
const tokenInput = document.getElementById('token');
tokenInput.value = localStorage.getItem('nomad_token') || '';
tokenInput.addEventListener('change', () => {
  localStorage.setItem('nomad_token', tokenInput.value); render();
});

async function api(path, method, body) {
  const headers = {};
  if (tokenInput.value) headers['X-Nomad-Token'] = tokenInput.value;
  const opts = {headers, method: method || 'GET'};
  if (body !== undefined) {
    headers['Content-Type'] = 'application/json';
    opts.body = JSON.stringify(body);
  }
  const resp = await fetch(path, opts);
  if (!resp.ok) throw new Error(resp.status + ' ' + ((await resp.json()).error || ''));
  return resp.json();
}
const badge = s => `<span class="status s-${s}">${s}</span>`;
const esc = x => String(x ?? '').replace(/[&<>"]/g,
  c => ({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;'}[c]));
// UTF-8-safe base64 (btoa alone throws on non-latin1 and mojibakes UTF-8);
// also the only safe way to embed untrusted strings (file names!) inside
// inline JS handlers — base64's charset can't break out of a JS string
const b64e = s => btoa(String.fromCharCode(...new TextEncoder().encode(s)));
const b64d = s => new TextDecoder().decode(
  Uint8Array.from(atob(s), c => c.charCodeAt(0)));

function table(headers, rows, onclickPrefix) {
  return `<table><tr>${headers.map(h=>`<th>${h}</th>`).join('')}</tr>` +
    rows.map(r => `<tr class="row" onclick="location.hash='${onclickPrefix}/${r.id}'">` +
      r.cells.map(c=>`<td>${c}</td>`).join('') + '</tr>').join('') + '</table>';
}

const routes = {
  async jobs() {
    const jobs = await api('/v1/jobs');
    return table(['ID','Type','Priority','Status'], jobs.map(j => ({
      id: encodeURIComponent(j.ID),
      cells: [esc(j.ID), esc(j.Type), j.Priority, badge(esc(j.Status))]
    })), '#/job');
  },
  async job(id) {
    const j = await api('/v1/job/' + id);
    let allocs = [], deps = [], evals = [], summary = null;
    try { allocs = await api('/v1/job/' + id + '/allocations'); } catch {}
    try { deps = await api('/v1/job/' + id + '/deployments'); } catch {}
    try { evals = await api('/v1/job/' + id + '/evaluations'); } catch {}
    try { summary = await api('/v1/job/' + id + '/summary'); } catch {}
    let html = `<div class="crumb"><a href="#/jobs">jobs</a> / ${esc(j.id)}</div>`;
    if (summary && summary.summary) {
      html += '<h3>Summary</h3>' +
        '<table><tr><th>Group</th><th>Queued</th><th>Starting</th><th>Running</th>' +
        '<th>Complete</th><th>Failed</th><th>Lost</th></tr>' +
        Object.entries(summary.summary).map(([g, s]) =>
          `<tr><td>${esc(g)}</td><td>${s.queued||0}</td><td>${s.starting||0}</td>` +
          `<td>${s.running||0}</td><td>${s.complete||0}</td><td>${s.failed||0}</td>` +
          `<td>${s.lost||0}</td></tr>`).join('') + '</table>';
    }
    html += '<h3>Allocations</h3>' +
      table(['Alloc','Group','Desired','Client','Node'], allocs.map(a => ({
        id: a.ID, cells: [esc(a.ID.slice(0,8)), esc(a.TaskGroup),
          badge(esc(a.DesiredStatus)), badge(esc(a.ClientStatus)),
          esc((a.NodeID||'').slice(0,8))]
      })), '#/allocation');
    if (deps.length) {
      html += '<h3>Deployments</h3>' +
        table(['ID','Version','Status','Description'], deps.map(d => ({
          id: d.id, cells: [esc(d.id.slice(0,8)), d.job_version,
            badge(esc(d.status)), esc(d.status_description || '')]
        })), '#/deployment');
    }
    if (evals.length) {
      html += '<h3>Evaluations</h3>' +
        table(['ID','Type','Triggered By','Status','Placement Failures'],
          evals.map(e => ({
            id: e.id, cells: [esc(e.id.slice(0,8)), esc(e.type),
              esc(e.triggered_by), badge(esc(e.status)),
              Object.keys(e.failed_tg_allocs || {}).length ? 'yes' : '']
          })), '#/evaluation');
    }
    return html + `<h3>Spec</h3><pre>${esc(JSON.stringify(j, null, 2))}</pre>`;
  },
  async nodes() {
    const nodes = await api('/v1/nodes');
    return table(['ID','Name','DC','Class','Status'], nodes.map(n => ({
      id: n.ID, cells: [esc(n.ID.slice(0,8)), esc(n.Name), esc(n.Datacenter),
        esc(n.NodeClass || '-'), badge(esc(n.Status))]
    })), '#/node');
  },
  async node(id) {
    const n = await api('/v1/node/' + id);
    let allocs = [];
    try { allocs = await api('/v1/node/' + id + '/allocations'); } catch {}
    let html = `<div class="crumb"><a href="#/nodes">nodes</a> / ${esc(n.name)}</div>` +
      `<dl class="kv">
        <dt>Status</dt><dd>${badge(esc(n.status))}</dd>
        <dt>Eligibility</dt><dd>${badge(esc(n.scheduling_eligibility))}${n.drain ? ' (draining)' : ''}</dd>
        <dt>Datacenter</dt><dd>${esc(n.datacenter)}</dd>
        <dt>Class</dt><dd>${esc(n.node_class || '-')}</dd>
        <dt>Drivers</dt><dd>${esc(Object.keys(n.drivers || {}).join(', ') || '-')}</dd>
      </dl>`;
    // node operator actions (ref ui node drain/eligibility controls)
    html += `<div class="actions">
      <button onclick="nodeAction('${n.id}','drain',{DrainSpec:{}})"
        ${n.drain ? 'disabled' : ''}>Drain</button>
      <button class="ghost" onclick="nodeAction('${n.id}','drain',{MarkEligible:true})"
        ${n.drain ? '' : 'disabled'}>Stop drain</button>
      <button class="ghost" onclick="nodeAction('${n.id}','eligibility',{Eligibility:'ineligible'})"
        ${n.scheduling_eligibility === 'eligible' ? '' : 'disabled'}>Mark ineligible</button>
      <button class="ghost" onclick="nodeAction('${n.id}','eligibility',{Eligibility:'eligible'})"
        ${n.scheduling_eligibility === 'eligible' ? 'disabled' : ''}>Mark eligible</button>
      <span id="nodeout"></span></div>`;
    html += '<h3>Allocations</h3>' +
      table(['Alloc','Job','Group','Client'], allocs.map(a => ({
        id: a.ID, cells: [esc(a.ID.slice(0,8)), esc(a.JobID), esc(a.TaskGroup),
          badge(esc(a.ClientStatus))]
      })), '#/allocation');
    const events = (n.events || []).slice(-8);
    if (events.length) {
      html += '<h3>Events</h3><table><tr><th>Time</th><th>Subsystem</th><th>Message</th></tr>' +
        events.map(e => `<tr><td>${new Date((e.timestamp||0)/1e6).toLocaleTimeString()}</td>` +
          `<td>${esc(e.subsystem)}</td><td>${esc(e.message)}</td></tr>`).join('') +
        '</table>';
    }
    return html + `<h3>Node</h3><pre>${esc(JSON.stringify(n, null, 2))}</pre>`;
  },
  async allocations() {
    const allocs = await api('/v1/allocations');
    return table(['ID','Job','Group','Desired','Client'], allocs.map(a => ({
      id: a.ID, cells: [esc(a.ID.slice(0,8)), esc(a.JobID), esc(a.TaskGroup),
        badge(esc(a.DesiredStatus)), badge(esc(a.ClientStatus))]
    })), '#/allocation');
  },
  async allocation(id) {
    const a = await api('/v1/allocation/' + id);
    const tasks = Object.keys(a.task_states || {});
    // task drill-down: state, lifecycle actions, events, live stats
    let tasksHtml = '<h3>Tasks</h3>';
    for (const t of tasks) {
      const ts = a.task_states[t];
      const ev = (ts.events || []).slice(-8);
      tasksHtml += `<div class="panel"><b>${esc(t)}</b> ${badge(esc(ts.state))}` +
        (ts.failed ? ' <span class="err">failed</span>' : '') +
        ` · restarts ${ts.restarts || 0}` +
        ` <button class="ghost" onclick="taskAction('${a.id}','restart','${b64e(t)}')">Restart</button>` +
        ` <button class="ghost" onclick="taskAction('${a.id}','signal','${b64e(t)}')">SIGINT</button>` +
        `<div id="spark-${esc(t)}" style="margin:.5rem 0"></div>` +
        (ev.length ? '<table><tr><th>Time</th><th>Type</th><th>Message</th></tr>' +
          ev.map(e => `<tr><td>${new Date((e.time||0)/1e6).toLocaleTimeString()}</td>` +
            `<td>${esc(e.type)}</td><td>${esc(e.message)}</td></tr>`).join('') +
          '</table>' : '') + '</div>';
    }
    tasksHtml += `<div class="actions">
      <button class="ghost" onclick="allocAction('${a.id}','stop')">Stop allocation</button>
      <span id="allocout"></span></div>`;
    let logsHtml = '';
    for (const t of tasks) {
      for (const kind of ['stdout', 'stderr']) {
        try {
          const l = await api(`/v1/client/fs/logs/${a.id}?task=${encodeURIComponent(t)}&type=${kind}&origin=end&offset=8192`);
          if (l.Data) {
            logsHtml += `<h3>${esc(t)} · ${kind} (tail)</h3><pre>${esc(l.Data)}</pre>`;
          }
        } catch {}
      }
    }
    const taskOpts = tasks.map(t => `<option>${esc(t)}</option>`).join('');
    window._postRender = () => { fsGo(a.id, b64e('/')); statsStart(a.id); };
    return `<div class="crumb"><a href="#/allocations">allocations</a> / ${esc(a.id.slice(0,8))}</div>` +
      tasksHtml +
      `<h3>Exec</h3>
       <div>task <select id="termtask">${taskOpts}</select>
         <button onclick="termConnect('${a.id}')">Connect /bin/sh</button>
         <button class="ghost" onclick="termClose()">Disconnect</button></div>
       <div id="term">(not connected)</div>
       <input id="termin" placeholder="command… (Enter to send)"
              onkeydown="if(event.key==='Enter')termSend()" />` +
      `<h3>Filesystem</h3><div id="fspath" class="fspath"></div>
       <div id="fsview">Loading…</div>` +
      logsHtml +
      `<h3>Allocation</h3><pre>${esc(JSON.stringify(a, null, 2))}</pre>`;
  },
  async run() {
    const saved = localStorage.getItem('nomad_run_hcl') ||
      'job "example" {\\n  datacenters = ["dc1"]\\n  group "web" {\\n    task "web" {\\n      driver = "raw_exec"\\n      config {\\n        command = "sleep"\\n        args    = ["300"]\\n      }\\n      resources {\\n        cpu    = 100\\n        memory = 64\\n      }\\n    }\\n  }\\n}\\n';
    return `<h3>Run a job</h3>
      <textarea id="hcl">${esc(saved)}</textarea>
      <div style="margin:.6rem 0">
        <button class="ghost" onclick="planJob()">Plan</button>
        <button onclick="runJob()">Run</button>
      </div>
      <div id="planout"></div>`;
  },
  async evaluations() {
    const evals = await api('/v1/evaluations');
    return table(['ID','Job','Type','Triggered By','Status','Placement Failures'],
      evals.map(e => ({
        id: e.id, cells: [esc(e.id.slice(0,8)), esc(e.job_id), esc(e.type),
          esc(e.triggered_by), badge(esc(e.status)),
          Object.keys(e.failed_tg_allocs || {}).length ? 'yes' : '']
      })), '#/evaluation');
  },
  async evaluation(id) {
    const e = await api('/v1/evaluation/' + id);
    let allocs = [];
    try { allocs = await api('/v1/evaluation/' + id + '/allocations'); } catch {}
    let html = `<div class="crumb"><a href="#/evaluations">evaluations</a> / ${esc(e.id.slice(0,8))}</div>` +
      `<dl class="kv">
        <dt>Job</dt><dd><a href="#/job/${encodeURIComponent(e.job_id)}">${esc(e.job_id)}</a></dd>
        <dt>Type</dt><dd>${esc(e.type)}</dd>
        <dt>Triggered by</dt><dd>${esc(e.triggered_by)}</dd>
        <dt>Status</dt><dd>${badge(esc(e.status))} ${esc(e.status_description || '')}</dd>
        <dt>Priority</dt><dd>${e.priority}</dd>
        ${e.blocked_eval ? `<dt>Blocked eval</dt><dd><a href="#/evaluation/${e.blocked_eval}">${esc(e.blocked_eval.slice(0,8))}</a></dd>` : ''}
        ${e.queued_allocations ? `<dt>Queued allocs</dt><dd>${esc(JSON.stringify(e.queued_allocations))}</dd>` : ''}
      </dl>`;
    const failed = e.failed_tg_allocs || {};
    if (Object.keys(failed).length) {
      html += '<h3 class="err">Placement failures</h3>';
      for (const [tg, m] of Object.entries(failed)) {
        const rows = [];
        rows.push(['Nodes evaluated', m.nodes_evaluated]);
        rows.push(['Nodes available', esc(JSON.stringify(m.nodes_available || {}))]);
        for (const [cls, n] of Object.entries(m.class_filtered || {}))
          rows.push([`Class ${esc(cls)} filtered`, n]);
        for (const [c, n] of Object.entries(m.constraint_filtered || {}))
          rows.push([`Constraint ${esc(c)}`, n]);
        rows.push(['Nodes exhausted', m.nodes_exhausted]);
        for (const [d, n] of Object.entries(m.dimension_exhausted || {}))
          rows.push([`Dimension ${esc(d)} exhausted`, n]);
        for (const [q, n] of Object.entries(m.quota_exhausted || {}))
          rows.push([`Quota ${esc(q)} exhausted`, n]);
        if (m.coalesced_failures)
          rows.push(['Coalesced failures', m.coalesced_failures]);
        html += `<div class="panel"><b>${esc(tg)}</b><table>` +
          rows.filter(([,v]) => v !== undefined && v !== 0 && v !== '{}')
            .map(([k,v]) => `<tr><td>${k}</td><td>${v}</td></tr>`).join('') +
          '</table></div>';
      }
    }
    if (allocs.length) {
      html += '<h3>Placed allocations</h3>' +
        table(['Alloc','Group','Desired','Client'], allocs.map(a => ({
          id: a.ID, cells: [esc(a.ID.slice(0,8)), esc(a.TaskGroup),
            badge(esc(a.DesiredStatus)), badge(esc(a.ClientStatus))]
        })), '#/allocation');
    }
    return html;
  },
  async deployments() {
    const deps = await api('/v1/deployments');
    return table(['ID','Job','Version','Status','Description'], deps.map(d => ({
      id: d.id, cells: [esc(d.id.slice(0,8)), esc(d.job_id), d.job_version,
        badge(esc(d.status)), esc(d.status_description || '')]
    })), '#/deployment');
  },
  async deployment(id) {
    const d = await api('/v1/deployment/' + id);
    let allocs = [];
    try { allocs = await api('/v1/deployment/allocations/' + d.id); } catch {}
    const active = d.status === 'running' || d.status === 'paused';
    const needsPromote = Object.values(d.task_groups || {}).some(
      s => s.desired_canaries > 0 && !s.promoted);
    let html = `<div class="crumb"><a href="#/deployments">deployments</a> / ${esc(d.id.slice(0,8))}</div>` +
      `<dl class="kv">
        <dt>Job</dt><dd><a href="#/job/${encodeURIComponent(d.job_id)}">${esc(d.job_id)}</a> (version ${d.job_version})</dd>
        <dt>Status</dt><dd>${badge(esc(d.status))} ${esc(d.status_description || '')}</dd>
      </dl>`;
    html += `<div class="actions">
      <button onclick="deployAction('${d.id}','promote',{All:true})"
        ${active && needsPromote ? '' : 'disabled'}>Promote canaries</button>
      <button class="ghost" onclick="deployAction('${d.id}','pause',{Pause:true})"
        ${d.status === 'running' ? '' : 'disabled'}>Pause</button>
      <button class="ghost" onclick="deployAction('${d.id}','pause',{Pause:false})"
        ${d.status === 'paused' ? '' : 'disabled'}>Resume</button>
      <button class="ghost" onclick="deployAction('${d.id}','fail')"
        ${active ? '' : 'disabled'}>Fail</button>
      <span id="deployout"></span></div>`;
    html += '<h3>Task groups</h3>' +
      '<table><tr><th>Group</th><th>Promoted</th><th>Desired</th><th>Canaries</th>' +
      '<th>Placed</th><th>Healthy</th><th>Unhealthy</th><th>Progress deadline</th></tr>' +
      Object.entries(d.task_groups || {}).map(([g, s]) =>
        `<tr><td>${esc(g)}</td>` +
        `<td>${s.desired_canaries > 0 ? (s.promoted ? '<span class="ok-note">yes</span>' : '<span class="warn-note">awaiting</span>') : '-'}</td>` +
        `<td>${s.desired_total}</td><td>${s.placed_canaries ? s.placed_canaries.length : 0}/${s.desired_canaries}</td>` +
        `<td>${s.placed_allocs}</td><td>${s.healthy_allocs}</td><td>${s.unhealthy_allocs}</td>` +
        `<td>${s.progress_deadline ? (s.progress_deadline / 1e9) + 's' : '-'}</td></tr>`
      ).join('') + '</table>';
    if (allocs.length) {
      html += '<h3>Allocations</h3>' +
        table(['Alloc','Group','Desired','Client','Healthy'], allocs.map(a => ({
          id: a.ID, cells: [esc(a.ID.slice(0,8)), esc(a.TaskGroup),
            badge(esc(a.DesiredStatus)), badge(esc(a.ClientStatus)),
            a.DeploymentStatus && a.DeploymentStatus.healthy != null
              ? (a.DeploymentStatus.healthy ? 'yes' : 'no') : '-']
        })), '#/allocation');
    }
    return html;
  },
  async services() {
    const svcs = await api('/v1/services');
    return table(['Service','Job','Alloc','Address','Status','Checks'], svcs.map(s => ({
      id: s.AllocID, cells: [esc(s.ServiceName), esc(s.JobID),
        esc(s.AllocID.slice(0,8)),
        esc(s.Address ? s.Address + ':' + s.Port : '-'),
        badge(esc(s.Status)),
        esc(Object.entries(s.Checks || {}).map(([k,v]) => k + '=' + v).join(' ') || '-')]
    })), '#/allocation');
  },
  async search(rawPrefix) {
    const prefix = decodeURIComponent(rawPrefix || '');
    if (!prefix) return '<div class="crumb">type a prefix in the search box</div>';
    const r = await api('/v1/search', 'PUT', {Prefix: prefix, Context: 'all'});
    const links = {jobs: '#/job/', evals: '#/evaluation/', allocs: '#/allocation/',
                   nodes: '#/node/', deployments: '#/deployment/'};
    let html = `<div class="crumb">search results for <b>${esc(prefix)}</b></div>`;
    let any = false;
    for (const [ctx, ids] of Object.entries(r.matches || {})) {
      if (!ids || !ids.length) continue;
      any = true;
      html += `<h3>${esc(ctx)}${(r.truncations||{})[ctx] ? ' (truncated)' : ''}</h3>` +
        '<table>' + ids.map(i =>
          `<tr class="row" onclick="location.hash='${links[ctx] || '#/jobs'}${encodeURIComponent(i)}'">` +
          `<td>${esc(i)}</td></tr>`).join('') + '</table>';
    }
    return any ? html : html + '<div class="crumb">no matches</div>';
  },
  async servers() {
    const m = await api('/v1/agent/members');
    let health = {Servers: []};
    try { health = await api('/v1/operator/autopilot/health'); } catch {}
    const byId = Object.fromEntries(health.Servers.map(s => [s.ID, s]));
    return `<div class="crumb">region ${esc(m.ServerRegion)}</div>` +
      table(['Name','Address','Gossip','Leader','Healthy','Last Contact'],
        m.Members.map(s => {
          const h = byId[s.Name] || {};
          return {id: '', cells: [esc(s.Name), esc(s.Addr + ':' + s.Port),
            badge(esc(s.Status)),
            h.Leader ? 'yes' : '', badge(h.Healthy === false ? 'failed' : 'ready'),
            esc(h.LastContact == null ? '-' : h.LastContact + 's')]};
        }), '#/servers');
  },
};

// ---- job submit + plan-diff (ref ui job-run routes) ----
async function parseHcl() {
  const hcl = document.getElementById('hcl').value;
  localStorage.setItem('nomad_run_hcl', hcl);
  return api('/v1/jobs/parse', 'PUT', {JobHCL: hcl});
}
function renderDiff(diff) {
  if (!diff) return '(no diff)';
  const lines = [];
  const mark = t => t === 'Added' ? 'diff-add' : t === 'Deleted' ? 'diff-del'
    : t === 'Edited' ? 'diff-edit' : '';
  const field = (f, pad) => lines.push(
    `${pad}<span class="${mark(f.Type)}">${esc(f.Name)}: ` +
    `${esc(f.Old||'∅')} → ${esc(f.New||'∅')}</span>`);
  const objects = (objs, pad) => {
    for (const o of (objs || [])) {
      lines.push(`${pad}<span class="${mark(o.Type)}">${esc(o.Name)}: ${esc(o.Type||'None')}</span>`);
      for (const f of (o.Fields || [])) field(f, pad + '  ');
      objects(o.Objects, pad + '  ');
    }
  };
  lines.push(`<span class="${mark(diff.Type)}">job ${esc(diff.Name)}: ${esc(diff.Type||'None')}</span>`);
  for (const f of (diff.Fields || [])) field(f, '  ');
  objects(diff.Objects, '  ');
  for (const tg of (diff.TaskGroups || [])) {
    lines.push(`  <span class="${mark(tg.Type)}">group ${esc(tg.Name)}: ${esc(tg.Type||'None')}</span>`);
    for (const f of (tg.Fields || [])) field(f, '    ');
    objects(tg.Objects, '    ');
    for (const t of (tg.Tasks || [])) {
      lines.push(`    <span class="${mark(t.Type)}">task ${esc(t.Name)}: ${esc(t.Type||'None')}</span>`);
      for (const f of (t.Fields || [])) field(f, '      ');
      objects(t.Objects, '      ');
    }
  }
  return lines.join('\\n');
}
async function planJob() {
  const out = document.getElementById('planout');
  try {
    const job = await parseHcl();
    const plan = await api('/v1/job/' + encodeURIComponent(job.id) + '/plan',
      'PUT', {Job: job, Diff: true});
    let html = `<h3>Plan</h3><pre>${renderDiff(plan.Diff)}</pre>`;
    if (plan.Annotations)
      html += `<pre>${esc(JSON.stringify(plan.Annotations, null, 2))}</pre>`;
    if (plan.FailedTGAllocs && Object.keys(plan.FailedTGAllocs).length)
      html += `<div class="err">Placement failures: ` +
        esc(JSON.stringify(plan.FailedTGAllocs)) + '</div>';
    out.innerHTML = html;
  } catch (e) { out.innerHTML = `<div class="err">${esc(e.message)}</div>`; }
}
async function runJob() {
  const out = document.getElementById('planout');
  try {
    const job = await parseHcl();
    const r = await api('/v1/jobs', 'PUT', {Job: job});
    out.innerHTML = `<div>Submitted: eval <code>${esc(r.EvalID || '')}</code>
      — <a href="#/job/${encodeURIComponent(job.id)}">view job</a></div>`;
  } catch (e) { out.innerHTML = `<div class="err">${esc(e.message)}</div>`; }
}

// ---- deployment + alloc lifecycle actions (ref ui deployment adapters
// promote/fail/pause and alloc restart/signal/stop routes) ----
async function deployAction(id, action, body) {
  const out = document.getElementById('deployout');
  try {
    await api('/v1/deployment/' + action + '/' + id, 'PUT', body || {});
    render();  // show the new deployment state
  } catch (e) { if (out) out.innerHTML = `<span class="err">${esc(e.message)}</span>`; }
}
async function nodeAction(nodeId, action, body) {
  const out = document.getElementById('nodeout');
  try {
    await api(`/v1/node/${nodeId}/${action}`, 'PUT', body || {});
    render();  // show the new node state
  } catch (e) { if (out) out.innerHTML = `<span class="err">${esc(e.message)}</span>`; }
}
async function taskAction(allocId, action, taskB64) {
  const out = document.getElementById('allocout');
  const task = b64d(taskB64);
  try {
    const body = action === 'signal' ? {Signal: 'SIGINT', TaskName: task}
                                     : {TaskName: task};
    await api(`/v1/client/allocation/${allocId}/${action}`, 'PUT', body);
    if (out) out.innerHTML = `<span class="ok-note">${esc(action)} sent to ${esc(task)}</span>`;
  } catch (e) { if (out) out.innerHTML = `<span class="err">${esc(e.message)}</span>`; }
}
async function allocAction(allocId, action) {
  const out = document.getElementById('allocout');
  try {
    await api(`/v1/allocation/${allocId}/${action}`, 'PUT', {});
    if (out) out.innerHTML = `<span class="ok-note">${esc(action)} requested</span>`;
  } catch (e) { if (out) out.innerHTML = `<span class="err">${esc(e.message)}</span>`; }
}

// ---- per-task live stats sparklines (ref ui stats charts; one measure
// per chart — CPU and memory never share an axis) ----
let statsTimer = null;
const statsHist = {};  // task -> {cpu: [..], rss: [..]}
function sparkline(points, fmt) {
  if (!points.length) return '';
  const w = 140, h = 28, pad = 2;
  const max = Math.max(...points, 1e-9);
  const step = points.length > 1 ? (w - 2*pad) / (points.length - 1) : 0;
  const ys = points.map(v => h - pad - (v / max) * (h - 2*pad));
  const d = ys.map((y, i) => `${(pad + i*step).toFixed(1)},${y.toFixed(1)}`).join(' ');
  return `<svg class="spark" width="${w}" height="${h}">` +
    `<polyline points="${d}" fill="none" stroke="#5b8dee" stroke-width="2"/></svg>` +
    `<span class="sparkval">${fmt(points[points.length-1])}</span>`;
}
async function statsPoll(allocId) {
  let s;
  try { s = await api(`/v1/client/allocation/${allocId}/stats`); }
  catch { return; }
  for (const [t, u] of Object.entries(s.tasks || {})) {
    const el = document.getElementById('spark-' + t);
    if (!el) continue;
    const hist = statsHist[t] = statsHist[t] || {cpu: [], rss: []};
    hist.cpu = hist.cpu.concat([u.cpu_percent || 0]).slice(-60);
    hist.rss = hist.rss.concat([(u.rss_bytes || 0) / 1048576]).slice(-60);
    el.innerHTML =
      'cpu ' + sparkline(hist.cpu, v => v.toFixed(1) + '%') +
      'mem ' + sparkline(hist.rss, v => v.toFixed(1) + ' MiB');
  }
}
function statsStart(allocId) {
  statsStop();
  statsPoll(allocId);
  statsTimer = setInterval(() => statsPoll(allocId), 2000);
}
function statsStop() {
  if (statsTimer) { clearInterval(statsTimer); statsTimer = null; }
  for (const k of Object.keys(statsHist)) delete statsHist[k];
}

// ---- allocation fs browser (ref ui fs routes) ----
// paths ride handlers base64-encoded: file names are UNTRUSTED (any
// workload writes them) and must never reach an inline-JS string raw
async function fsGo(allocId, pathB64) {
  const path = b64d(pathB64);
  const pathDiv = document.getElementById('fspath');
  const viewDiv = document.getElementById('fsview');
  if (!pathDiv || !viewDiv) return;
  const parts = path.split('/').filter(Boolean);
  let crumbs = `<a href="javascript:fsGo('${allocId}','${b64e('/')}')">alloc</a>`;
  let acc = '';
  for (const p of parts) {
    acc += '/' + p;
    crumbs += ` / <a href="javascript:fsGo('${allocId}','${b64e(acc)}')">${esc(p)}</a>`;
  }
  pathDiv.innerHTML = crumbs;
  try {
    const entries = await api('/v1/client/fs/ls/' + allocId +
      '?path=' + encodeURIComponent(path));
    viewDiv.innerHTML = '<table><tr><th>Name</th><th>Size</th></tr>' +
      entries.map(e => {
        const full = b64e((path === '/' ? '' : path) + '/' + e.Name);
        const go = e.IsDir ? `fsGo('${allocId}','${full}')`
                           : `fsCat('${allocId}','${full}')`;
        return `<tr class="row" onclick="${go}"><td>${e.IsDir?'📁 ':''}${esc(e.Name)}</td>` +
               `<td>${e.IsDir?'-':e.Size}</td></tr>`;
      }).join('') + '</table>';
  } catch (e) { viewDiv.innerHTML = `<div class="err">${esc(e.message)}</div>`; }
}
async function fsCat(allocId, pathB64) {
  const path = b64d(pathB64);
  const viewDiv = document.getElementById('fsview');
  const parent = b64e(path.split('/').slice(0,-1).join('/') || '/');
  try {
    const doc = await api('/v1/client/fs/cat/' + allocId +
      '?path=' + encodeURIComponent(path));
    viewDiv.innerHTML = `<div class="crumb">${esc(path)}
      (<a href="javascript:fsGo('${allocId}','${parent}')">back</a>)</div>` +
      `<pre>${esc(doc.Data)}</pre>`;
  } catch (e) { viewDiv.innerHTML = `<div class="err">${esc(e.message)}</div>`; }
}

// ---- exec terminal over the exec websocket (ref ui exec routes) ----
let termWs = null;
function termWrite(text) {
  const term = document.getElementById('term');
  if (!term) return;
  term.textContent += text;
  term.scrollTop = term.scrollHeight;
}
function termConnect(allocId) {
  termClose();
  const task = document.getElementById('termtask').value;
  const proto = location.protocol === 'https:' ? 'wss:' : 'ws:';
  let url = `${proto}//${location.host}/v1/client/allocation/${allocId}/exec` +
    `?task=${encodeURIComponent(task)}&command=${encodeURIComponent('["/bin/sh"]')}`;
  if (tokenInput.value) url += `&token=${encodeURIComponent(tokenInput.value)}`;
  document.getElementById('term').textContent = '';
  termWrite('[connecting…]\\n');
  const ws = new WebSocket(url);
  termWs = ws;
  ws.onmessage = ev => {
    if (termWs !== ws) return;  // superseded by a reconnect
    try {
      const m = JSON.parse(ev.data);
      if (m.stdout && m.stdout.data) termWrite(b64d(m.stdout.data));
      if (m.stderr && m.stderr.data) termWrite(b64d(m.stderr.data));
      if (m.exited) termWrite(`\\n[exited ${(m.result||{}).exit_code}]\\n`);
      if (m.error) termWrite(`\\n[error: ${m.error}]\\n`);
    } catch {}
  };
  ws.onopen = () => { if (termWs === ws) termWrite('[connected]\\n$ '); };
  ws.onclose = () => {
    // an OLD socket closing must not null out (or scribble over) a newer
    // live connection's state
    if (termWs === ws) { termWrite('\\n[disconnected]\\n'); termWs = null; }
  };
}
function termSend() {
  const input = document.getElementById('termin');
  if (!termWs || termWs.readyState !== 1) return;
  const line = input.value + '\\n';
  termWrite(line);
  termWs.send(JSON.stringify({stdin: {data: b64e(line)}}));
  input.value = '';
}
function termClose() {
  if (termWs) { try { termWs.close(); } catch {} termWs = null; }
}

async function render() {
  const hash = location.hash || '#/jobs';
  const [, page, id] = hash.split('/');
  if (page !== 'allocation') statsStop();
  document.querySelectorAll('nav a').forEach(a =>
    a.classList.toggle('active', a.getAttribute('href') === '#/' + page));
  const fn = routes[page] || routes.jobs;
  const gen = ++renderGen;
  window._postRender = null;
  try {
    const html = await fn(id);
    if (gen !== renderGen) return;  // superseded by a newer navigation
    view.innerHTML = html;
    if (window._postRender) window._postRender();
  }
  catch (e) {
    if (gen !== renderGen) return;
    view.innerHTML = `<div class="err">${esc(e.message)}</div>`;
  }
}
let renderGen = 0;
window.addEventListener('hashchange', render);

// ---- live updates over /v1/event/stream (push instead of poll; the
// 3s poll below stays as the blocking-query-style fallback whenever the
// stream is unavailable — no broker, ACL denial, proxy buffering) ----
let streamLive = false, streamPending = false;
function refreshable() {
  const h = location.hash || '';
  // no auto-refresh on detail pages or the Run editor (it would wipe
  // in-progress HCL edits, the exec terminal, and the plan output)
  return !(h.match(/#\\/(job|node|allocation)\\//) || h.startsWith('#/run'));
}
async function eventStream() {
  try {
    const headers = {};
    if (tokenInput.value) headers['X-Nomad-Token'] = tokenInput.value;
    const resp = await fetch('/v1/event/stream', {headers});
    if (!resp.ok || !resp.body) throw new Error('stream unavailable');
    streamLive = true;
    const reader = resp.body.getReader();
    const dec = new TextDecoder();
    let buf = '';
    for (;;) {
      const {value, done} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      let nl, saw = false;
      while ((nl = buf.indexOf('\\n')) >= 0) {
        const line = buf.slice(0, nl); buf = buf.slice(nl + 1);
        if (!line.trim()) continue;
        try {
          const f = JSON.parse(line);
          if ((f.Events && f.Events.length) || f.LostGap) saw = true;
        } catch {}
      }
      if (saw && !streamPending && refreshable()) {
        // coalesce event bursts into at most one re-render per 500ms
        streamPending = true;
        setTimeout(() => { streamPending = false; if (refreshable()) render(); }, 500);
      }
    }
  } catch {}
  streamLive = false;
  setTimeout(eventStream, 3000);  // reconnect with backoff
}
eventStream();

setInterval(() => {
  if (streamLive || !refreshable()) return;  // push path is driving
  render();
}, 3000);
render();
</script>
</body>
</html>
"""
