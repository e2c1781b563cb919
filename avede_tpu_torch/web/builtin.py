"""Dependency-free single-page UI served at ``/ui`` (counterpart of
``avede_tpu/web/builtin.py``): text query, person detection and image
matching against the REST API. The page is the JAX package's, byte for
byte, so both servers answer ``GET /ui`` alike.
"""

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8">
<title>Video Event Detection (TPU)</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#0f1115;color:#e6e6e6}
 header{padding:14px 24px;background:#161a22;border-bottom:1px solid #242a35}
 h1{font-size:18px;margin:0}
 main{display:grid;grid-template-columns:320px 1fr;gap:0;min-height:calc(100vh - 49px)}
 aside{background:#12151c;padding:18px;border-right:1px solid #242a35}
 section{padding:18px 24px}
 label{display:block;margin:10px 0 4px;font-size:13px;color:#9aa4b2}
 input,select,button,textarea{width:100%;box-sizing:border-box;background:#1b212c;
   color:#e6e6e6;border:1px solid #2c3442;border-radius:6px;padding:8px;font-size:14px}
 button{background:#2563eb;border:none;cursor:pointer;margin-top:12px;font-weight:600}
 button:hover{background:#1d4ed8}
 .tab{display:inline-block;width:auto;margin-right:8px;background:#1b212c}
 .tab.active{background:#2563eb}
 .card{background:#161a22;border:1px solid #242a35;border-radius:8px;
   padding:12px;margin:10px 0;font-size:13px}
 .score{color:#4ade80;font-weight:700}
 pre{white-space:pre-wrap;word-break:break-all;color:#9aa4b2;margin:6px 0 0}
 #status{font-size:13px;color:#fbbf24;margin-top:10px;min-height:18px}
 video{max-width:480px;border-radius:6px;margin-top:8px}
</style></head><body>
<header><h1>🎬 Advanced Video Event Detection &amp; Extraction — TPU-native</h1></header>
<main>
<aside>
  <label>Upload video</label><input type="file" id="vidfile" accept="video/*">
  <button onclick="uploadVideo()">Upload video</button>
  <label>Video</label><select id="video"></select>
  <label>Reference image (person / image matching)</label>
  <input type="file" id="imgfile" accept="image/*">
  <button onclick="uploadImage()">Upload image</button>
  <label>Image</label><select id="image"></select>
  <div id="status"></div>
</aside>
<section>
  <button class="tab active" id="t0" onclick="tab(0)">Text query</button>
  <button class="tab" id="t1" onclick="tab(1)">Person detection</button>
  <button class="tab" id="t2" onclick="tab(2)">Image matching</button>

  <div id="p0">
    <label>Query</label><input id="query" value="a person walking">
    <label>Pipeline</label>
    <select id="qmode"><option>mvp</option><option>reranked</option>
      <option>advanced</option></select>
    <button onclick="runQuery()">Search</button>
  </div>
  <div id="p1" style="display:none">
    <label>Similarity threshold</label>
    <input id="pthr" type="number" value="0.6" step="0.05" min="0" max="1">
    <label>Frame skip</label>
    <input id="pskip" type="number" value="5" min="1" max="30">
    <button onclick="runPerson()">Find person</button>
  </div>
  <div id="p2" style="display:none">
    <label>Matching mode</label>
    <select id="mmode"><option>smart_match</option><option>cross_domain</option>
      <option>object_focused</option><option>traditional</option>
      <option>hybrid</option><option>fast_match</option></select>
    <label>Similarity threshold</label>
    <input id="mthr" type="number" value="0.55" step="0.05" min="0" max="1">
    <button onclick="runMatch()">Match</button>
  </div>
  <div id="results"></div>
</section>
</main>
<script>
const $=id=>document.getElementById(id);
function tab(i){for(let j=0;j<3;j++){$('p'+j).style.display=i==j?'':'none';
  $('t'+j).className='tab'+(i==j?' active':'');}}
function status(m){$('status').textContent=m;}
async function refresh(){
  const v=await (await fetch('/api/videos')).json();
  $('video').innerHTML=v.videos.map(x=>`<option>${x.video_id}</option>`).join('');
  $('video').selectedIndex=v.videos.length-1;
  const im=await (await fetch('/api/images')).json();
  $('image').innerHTML=im.images.map(x=>`<option>${x.image_id}</option>`).join('');
  $('image').selectedIndex=im.images.length-1;
}
async function uploadVideo(){
  const f=$('vidfile').files[0]; if(!f){status('pick a video file');return}
  status('uploading…');
  const fd=new FormData(); fd.append('file', f);
  const r=await (await fetch('/api/upload',{method:'POST',body:fd})).json();
  status('uploaded '+(r.video_id||JSON.stringify(r))); refresh();
}
async function uploadImage(){
  const f=$('imgfile').files[0]; if(!f){status('pick an image');return}
  const fd=new FormData(); fd.append('file', f);
  const r=await (await fetch('/api/upload-image',{method:'POST',body:fd})).json();
  status('uploaded image '+(r.image_id||JSON.stringify(r))); refresh();
}
function card(r){
  const conf=(r.confidence??r.similarity??0).toFixed(3);
  let html=`<div class=card><span class=score>${conf}</span>
    &nbsp; t=${(r.timestamp??0).toFixed(2)}s &nbsp; ${r.phase||r.method||''}`;
  if(r.caption) html+=`<br>caption: ${r.caption}`;
  if(r.start_time!==undefined)
    html+=`<br>segment: ${r.start_time.toFixed(2)}–${r.end_time.toFixed(2)}s`;
  if(r.clip_filename)
    html+=`<br><video controls src="/api/download/${r.clip_filename}"></video>`;
  html+=`<pre>${JSON.stringify(r,null,1).slice(0,600)}</pre></div>`;
  return html;
}
async function runQuery(){
  status('scanning…'); $('results').innerHTML='';
  const r=await (await fetch('/api/query',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({video_id:$('video').value,query:$('query').value,
      mode:$('qmode').value})})).json();
  status(`${r.status}: ${r.total_found??0} events`);
  $('results').innerHTML=(r.results||[]).map(card).join('');
}
async function runPerson(){
  status('searching for person…'); $('results').innerHTML='';
  const r=await (await fetch('/api/enhanced-person-detection',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({video_id:$('video').value,image_id:$('image').value,
      similarity_threshold:parseFloat($('pthr').value),
      frame_skip:parseInt($('pskip').value)})})).json();
  status(`${r.status}: ${r.total_found??0} matches`);
  const s=r.summary||{};
  $('results').innerHTML=`<div class=card>best=${(s.best_similarity??0).toFixed(3)}
    mean=${(s.mean_similarity??0).toFixed(3)} fps=${(s.fps??0).toFixed(1)}
    segments=${JSON.stringify(s.presence_segments||[])}</div>`+
    (r.results||[]).map(card).join('');
}
async function runMatch(){
  status('matching…'); $('results').innerHTML='';
  const r=await (await fetch('/api/image-matching-by-id',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({video_id:$('video').value,image_id:$('image').value,
      matching_mode:$('mmode').value,
      similarity_threshold:parseFloat($('mthr').value)})})).json();
  status(`${r.status}: ${r.total_found??0} matches`);
  $('results').innerHTML=(r.results||[]).map(card).join('');
}
refresh();
</script></body></html>
"""
