"""Self-hosted web UI of the port, served at ``/ui``.

The port's copy of video_enhancer_tpu/serving/ui.py: one static page
(upload with engine and latency controls, live job polling, job history,
a log tail) that drives the REST routes of ``serving/app.py``, which are
the JAX package's. Only its title differs.
"""

UI_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>video-enhancer-tpu (PyTorch/CUDA)</title>
<style>
  :root { color-scheme: dark; }
  body { font-family: system-ui, sans-serif; margin: 0; background: #0f1115;
         color: #e6e6e6; }
  header { padding: 18px 28px; background: #161a22;
           border-bottom: 1px solid #252a35; }
  h1 { margin: 0; font-size: 20px; } h1 span { color: #7aa2f7; }
  main { max-width: 960px; margin: 24px auto; padding: 0 16px;
         display: grid; gap: 20px; }
  .card { background: #161a22; border: 1px solid #252a35; border-radius: 10px;
          padding: 18px; }
  label { display: block; font-size: 13px; margin: 10px 0 4px; color: #9aa3b2; }
  select, input[type=file] { width: 100%; padding: 8px; background: #0f1115;
          color: #e6e6e6; border: 1px solid #2a3040; border-radius: 6px; }
  button { margin-top: 14px; padding: 10px 22px; background: #7aa2f7;
           border: 0; border-radius: 6px; color: #0f1115; font-weight: 600;
           cursor: pointer; }
  button:disabled { opacity: .5; cursor: wait; }
  table { width: 100%; border-collapse: collapse; font-size: 13px; }
  th, td { text-align: left; padding: 6px 8px;
           border-bottom: 1px solid #252a35; }
  .ok { color: #9ece6a; } .bad { color: #f7768e; } .run { color: #e0af68; }
  pre { background: #0b0d11; border-radius: 6px; padding: 10px;
        max-height: 220px; overflow: auto; font-size: 11px; }
  a { color: #7aa2f7; }
</style>
</head>
<body>
<header><h1>video-enhancer-<span>tpu</span></h1></header>
<main>
  <div class="card">
    <h3>Enhance a video</h3>
    <label>Video file</label>
    <input type="file" id="file" accept="video/*">
    <label>Engine</label>
    <select id="engine">
      <option value="">auto (degradation router)</option>
    </select>
    <label>Latency class</label>
    <select id="latency">
      <option>standard</option><option>strict</option><option>flexible</option>
    </select>
    <button id="go" onclick="submitJob()">Enhance</button>
    <button onclick="runDemo()" style="background:#9ece6a">Run demo</button>
    <div id="msg"></div>
  </div>
  <div class="card">
    <h3>Jobs</h3>
    <table id="jobs"><tr><th>id</th><th>file</th><th>strategy</th>
      <th>status</th><th>progress</th><th></th></tr></table>
  </div>
  <div class="card">
    <h3>Live log</h3>
    <pre id="log"></pre>
  </div>
</main>
<script>
async function loadStrategies() {
  const r = await fetch('/api/v1/strategies'); const d = await r.json();
  const sel = document.getElementById('engine');
  for (const s of d.strategies) {
    const o = document.createElement('option');
    o.value = s.name; o.textContent = s.name + ' (x' + s.scale + ')';
    sel.appendChild(o);
  }
}
async function submitJob() {
  const f = document.getElementById('file').files[0];
  if (!f) { document.getElementById('msg').textContent = 'pick a file'; return; }
  const fd = new FormData();
  fd.append('file', f);
  const eng = document.getElementById('engine').value;
  if (eng) fd.append('vsr_strategy', eng);
  fd.append('latency_class', document.getElementById('latency').value);
  document.getElementById('go').disabled = true;
  const r = await fetch('/api/v1/process/auto', {method: 'POST', body: fd});
  const d = await r.json();
  document.getElementById('go').disabled = false;
  document.getElementById('msg').textContent =
    r.ok ? ('queued: ' + d.job_id + ' via ' + d.strategy)
         : ('error: ' + (d.error ? d.error.message : r.status));
  refreshJobs();
}
async function refreshJobs() {
  const r = await fetch('/api/v1/jobs?limit=12'); const d = await r.json();
  const t = document.getElementById('jobs');
  while (t.rows.length > 1) t.deleteRow(1);
  for (const j of d.jobs) {
    const row = t.insertRow();
    const cls = j.status === 'completed' ? 'ok'
               : j.status === 'failed' ? 'bad' : 'run';
    const evalStr = j.evaluation
      ? (' psnr ' + j.evaluation.psnr.toFixed(1)
         + ' ssim ' + j.evaluation.ssim.toFixed(2)) : '';
    row.innerHTML = '<td>' + j.job_id.slice(0, 8) + '</td><td>'
      + (j.filename || '') + '</td><td>' + (j.strategy || '') + '</td>'
      + '<td class="' + cls + '">' + j.status + evalStr + '</td>'
      + '<td>' + Math.round((j.progress || 0) * 100) + '%</td>'
      + '<td>' + (j.status === 'completed'
          ? '<a href="/api/v1/job/' + j.job_id + '/download">download</a> '
            + '<a href="#" onclick="evalJob(\\'' + j.job_id
            + '\\');return false">eval</a>'
          : '') + '</td>';
  }
}
async function runDemo() {
  const eng = document.getElementById('engine').value || 'cnn_upscaler';
  const r = await fetch('/api/v1/demo', {method: 'POST',
    headers: {'Content-Type': 'application/json'},
    body: JSON.stringify({strategy: eng})});
  const d = await r.json();
  document.getElementById('msg').textContent =
    r.ok ? ('demo queued: ' + d.job_id) : 'demo failed';
  refreshJobs();
}
async function evalJob(id) {
  await fetch('/api/v1/job/' + id + '/evaluate', {method: 'POST'});
  refreshJobs();
}
async function refreshLog() {
  const r = await fetch('/logs?n=40'); const d = await r.json();
  document.getElementById('log').textContent = d.lines.join('\\n');
}
loadStrategies(); refreshJobs();
setInterval(refreshJobs, 3000); setInterval(refreshLog, 4000);
</script>
</body>
</html>
"""


def register_ui(router) -> None:
    from .http import Response

    @router.get("/ui")
    def ui(req):
        return Response(UI_HTML.encode(), content_type="text/html")
