"""Built-in web page for interactive use (copy of eitx/serve/frontend.py).

Parity with the reference Streamlit app (frontend/front.py:52-242 +
frontend_utils.py:9-85): a five-mode radio, drag-drop multi-file upload,
client-side zip packing (including the custom_input.txt side channel for
the custom-offset mode, frontend_utils.py:44-58), and per-stage timing
display from the JSON answer. The zip is built in vanilla JS (STORE
entries + CRC32 central directory) so the page works with zero external
resources — no CDN, no Streamlit container."""

FRONTEND_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>eitx — CT to EIT synthesizer</title>
<style>
 body{font-family:sans-serif;max-width:960px;margin:2em auto;padding:0 1em}
 fieldset{border:1px solid #ccc;margin-bottom:1em}
 img{max-width:100%;border:1px solid #ddd;margin-top:1em}
 .t{color:#555;font-size:0.9em}
 #drop{border:2px dashed #aaa;border-radius:8px;padding:1.4em;text-align:center;
   color:#777;margin:0.4em 0}
 #drop.hover{border-color:#36c;color:#36c;background:#f4f8ff}
 #flist{font-size:0.85em;color:#444;max-height:8em;overflow:auto}
 table.tm{border-collapse:collapse;margin-top:0.6em}
 table.tm td,table.tm th{border:1px solid #ddd;padding:2px 10px;
   font-size:0.9em;text-align:right}
 #custom-row{display:none;margin-top:0.4em}
 progress{width:100%}
</style></head><body>
<h2>eitx — synthetic EIT dataset generator</h2>
<fieldset><legend>Mode</legend>
 <label><input type=radio name=mode value="/uploadDicomSequence" checked>
   DICOM series (auto slice between ribs 6-7)</label><br>
 <label><input type=radio name=mode value="/uploadDicomSequenceCustom">
   DICOM series (custom slice offset)</label><br>
 <label><input type=radio name=mode value="/uploadDicomFrame">
   Single DICOM slice</label><br>
 <label><input type=radio name=mode value="/uploadImageAxialSlice">
   JPEG/PNG axial slice</label><br>
 <label><input type=radio name=mode value="/uploadNII">
   NIfTI volume (.nii / .nii.gz)</label>
 <div id=custom-row>slice offset (custom_input.txt):
   <input type=number id=custom value=0 style="width:5em"></div>
</fieldset>
<fieldset><legend>Upload</legend>
 <div id=drop>drop files here or
   <input type=file id=files multiple></div>
 <div id=flist></div>
 <button id=go onclick="launch()">Launch processing</button>
</fieldset>
<div id=status class=t></div>
<div id=timings></div>
<div id=out></div>
<script>
'use strict';
let picked = [];
const drop = document.getElementById('drop');
const flist = document.getElementById('flist');
const filesInput = document.getElementById('files');
function showList(){
  flist.textContent = picked.length ?
    picked.length + ' file(s): ' + picked.map(f=>f.name).join(', ') : '';
}
filesInput.addEventListener('change', () => {
  picked = Array.from(filesInput.files); showList();
});
['dragenter','dragover'].forEach(ev => drop.addEventListener(ev, e => {
  e.preventDefault(); drop.classList.add('hover');
}));
['dragleave','drop'].forEach(ev => drop.addEventListener(ev, e => {
  e.preventDefault(); drop.classList.remove('hover');
}));
drop.addEventListener('drop', e => {
  picked = Array.from(e.dataTransfer.files); showList();
});
document.querySelectorAll('input[name=mode]').forEach(r =>
  r.addEventListener('change', () => {
    document.getElementById('custom-row').style.display =
      r.value.endsWith('Custom') && r.checked ? 'block' : 'none';
  }));

// ---- minimal ZIP (STORE) writer: local headers + central directory ----
const CRC_TABLE = (() => {
  const t = new Uint32Array(256);
  for (let n = 0; n < 256; n++) {
    let c = n;
    for (let k = 0; k < 8; k++) c = c & 1 ? 0xEDB88320 ^ (c >>> 1) : c >>> 1;
    t[n] = c >>> 0;
  }
  return t;
})();
function crc32(buf){
  let c = 0xFFFFFFFF;
  for (let i = 0; i < buf.length; i++)
    c = CRC_TABLE[(c ^ buf[i]) & 0xFF] ^ (c >>> 8);
  return (c ^ 0xFFFFFFFF) >>> 0;
}
function makeZip(entries){  // entries: [{name, data(Uint8Array)}]
  const enc = new TextEncoder();
  const chunks = [], central = [];
  let offset = 0;
  const u16 = v => new Uint8Array([v & 255, (v >> 8) & 255]);
  const u32 = v => new Uint8Array(
    [v & 255, (v >> 8) & 255, (v >> 16) & 255, (v >>> 24) & 255]);
  for (const {name, data} of entries){
    const n = enc.encode(name), crc = crc32(data);
    const head = [u32(0x04034b50), u16(20), u16(0), u16(0), u16(0), u16(0),
      u32(crc), u32(data.length), u32(data.length), u16(n.length), u16(0)];
    const local = new Uint8Array(30 + n.length + data.length);
    let p = 0;
    for (const part of head){ local.set(part, p); p += part.length; }
    local.set(n, p); local.set(data, p + n.length);
    chunks.push(local);
    const c = new Uint8Array(46 + n.length);
    p = 0;
    for (const part of [u32(0x02014b50), u16(20), u16(20), u16(0), u16(0),
      u16(0), u16(0), u32(crc), u32(data.length), u32(data.length),
      u16(n.length), u16(0), u16(0), u16(0), u16(0), u32(0), u32(offset)]){
      c.set(part, p); p += part.length;
    }
    c.set(n, p);
    central.push(c);
    offset += local.length;
  }
  const cdSize = central.reduce((s, c) => s + c.length, 0);
  const end = new Uint8Array(22);
  let p = 0;
  for (const part of [u32(0x06054b50), u16(0), u16(0), u16(entries.length),
    u16(entries.length), u32(cdSize), u32(offset), u16(0)]){
    end.set(part, p); p += part.length;
  }
  return new Blob([...chunks, ...central, end], {type: 'application/zip'});
}

async function launch(){
  if(!picked.length){alert('choose files');return}
  const st = document.getElementById('status');
  const go = document.getElementById('go');
  go.disabled = true;
  try {
    st.textContent = 'packing ' + picked.length + ' file(s)...';
    const entries = [];
    for (const f of picked)
      entries.push({name: f.name, data: new Uint8Array(await f.arrayBuffer())});
    const mode = document.querySelector('input[name=mode]:checked').value;
    if (mode.endsWith('Custom'))
      entries.push({name: 'custom_input.txt', data: new TextEncoder().encode(
        String(document.getElementById('custom').value || '0'))});
    const blob = makeZip(entries);
    st.textContent = 'processing (first request compiles kernels; later ' +
      'requests are fast)...';
    const t0 = performance.now();
    const resp = await fetch(mode, {method: 'POST', body: blob,
      headers: {'Content-Type': 'application/zip'}});
    const ans = await resp.json();
    const total = (performance.now() - t0) / 1000;
    if(!resp.ok){
      st.textContent = 'error: ' + (ans.detail || resp.status); return;
    }
    st.textContent = 'done';
    document.getElementById('timings').innerHTML =
      '<table class=tm><tr><th>stage</th><th>seconds</th></tr>' +
      '<tr><td>segmentation</td><td>' + ans.segmentation_time + '</td></tr>' +
      '<tr><td>EIT simulation</td><td>' +
        Number(ans.simulation_time).toFixed(2) + '</td></tr>' +
      '<tr><td>request total</td><td>' + total.toFixed(1) + '</td></tr>' +
      '<tr><td colspan=2 style="text-align:left">dataset: ' +
        (ans.saved_file_name || '(not saved)') + '</td></tr></table>';
    document.getElementById('out').innerHTML =
      '<img src="data:image/png;base64,' + ans.image + '">';
  } finally {
    go.disabled = false;
  }
}
</script></body></html>
"""
