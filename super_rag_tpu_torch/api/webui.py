"""Built-in web UI (port of the JAX package's api/webui.py): one static
page, no build step.

A self-contained console at ``/`` covering login and register,
collections, document upload, hybrid search and streaming chat, enough
to drive every core flow from a browser.  ``PAGE`` is the JAX package's
page byte for byte.
"""

from __future__ import annotations

from super_rag_tpu_torch.api.http import Request, Response, Router

PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>super-rag-tpu</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root { --bg:#0f1117; --panel:#181b24; --line:#2a2f3d; --text:#e6e8ee;
        --dim:#9aa1b2; --acc:#7aa2f7; --ok:#9ece6a; --warn:#e0af68; }
* { box-sizing:border-box; }
body { margin:0; background:var(--bg); color:var(--text);
       font:14px/1.5 system-ui, sans-serif; }
header { display:flex; align-items:center; gap:12px; padding:10px 16px;
         border-bottom:1px solid var(--line); }
header h1 { font-size:15px; margin:0; color:var(--acc); }
header .who { margin-left:auto; color:var(--dim); font-size:12px; }
main { display:grid; grid-template-columns:260px 1fr; gap:0;
       height:calc(100vh - 45px); }
#side { border-right:1px solid var(--line); padding:12px; overflow:auto; }
#content { padding:16px; overflow:auto; }
.panel { background:var(--panel); border:1px solid var(--line);
         border-radius:8px; padding:12px; margin-bottom:12px; }
input, textarea, select { background:#11141c; color:var(--text);
  border:1px solid var(--line); border-radius:6px; padding:7px 9px;
  font:inherit; width:100%; }
button { background:var(--acc); color:#0b0d12; border:0; border-radius:6px;
  padding:7px 12px; font:inherit; font-weight:600; cursor:pointer; }
button.ghost { background:transparent; color:var(--acc);
  border:1px solid var(--acc); }
.coll { padding:8px 10px; border-radius:6px; cursor:pointer;
        border:1px solid transparent; }
.coll:hover { background:#1d2130; }
.coll.active { border-color:var(--acc); background:#1d2130; }
.hit { border-left:3px solid var(--acc); padding:8px 10px; margin:8px 0;
       background:#141824; border-radius:0 6px 6px 0; }
.hit .meta { color:var(--dim); font-size:12px; }
.row { display:flex; gap:8px; align-items:center; }
.row > * { flex:1; }
.row > button { flex:0 0 auto; }
.msg { margin:8px 0; padding:8px 12px; border-radius:8px; max-width:80%; }
.msg.user { background:#223; margin-left:auto; }
.msg.assistant { background:#1a2420; }
.badge { font-size:11px; color:var(--dim); }
.tabs { display:flex; gap:6px; margin-bottom:12px; }
.tabs button { background:transparent; color:var(--dim);
  border:1px solid var(--line); }
.tabs button.on { color:var(--text); border-color:var(--acc); }
pre { white-space:pre-wrap; }
#log { color:var(--warn); font-size:12px; min-height:18px; }
</style></head><body>
<header><h1>super-rag-tpu</h1><span id="log"></span>
<span class="who" id="who"></span></header>
<main>
<div id="side">
  <div class="panel" id="authPanel">
    <div class="row"><input id="u" placeholder="username">
    <input id="p" type="password" placeholder="password"></div>
    <div class="row" style="margin-top:8px">
      <button onclick="login()">Login</button>
      <button class="ghost" onclick="register()">Register</button></div>
  </div>
  <div class="panel">
    <div class="row"><input id="newColl" placeholder="new collection">
      <button onclick="createColl()">+</button></div>
  </div>
  <div id="collList"></div>
</div>
<div id="content">
  <div class="tabs">
    <button id="tab-search" class="on" onclick="tab('search')">Search</button>
    <button id="tab-docs" onclick="tab('docs')">Documents</button>
    <button id="tab-chat" onclick="tab('chat')">Chat</button>
  </div>
  <div id="pane-search">
    <div class="panel"><div class="row">
      <input id="q" placeholder="hybrid search query"
             onkeydown="if(event.key==='Enter')search()">
      <button onclick="search()">Search</button></div></div>
    <div id="hits"></div>
  </div>
  <div id="pane-docs" style="display:none">
    <div class="panel"><div class="row">
      <input id="file" type="file" multiple>
      <button onclick="upload()">Upload</button></div></div>
    <div id="docs"></div>
  </div>
  <div id="pane-chat" style="display:none">
    <div id="chatlog" class="panel" style="min-height:300px"></div>
    <div class="row"><input id="chatmsg" placeholder="ask the collection"
      onkeydown="if(event.key==='Enter')sendChat()">
      <button onclick="sendChat()">Send</button></div>
  </div>
</div>
</main>
<script>
let token = localStorage.getItem('tok') || '';
let coll = null, chatId = null;
const $$ = id => document.getElementById(id);
const log = m => { $$('log').textContent = m || ''; };
async function api(method, path, body, isForm) {
  const headers = token ? {Authorization: 'Bearer ' + token} : {};
  if (body && !isForm) headers['Content-Type'] = 'application/json';
  const r = await fetch(path, {method, headers,
    body: body ? (isForm ? body : JSON.stringify(body)) : undefined});
  if (!r.ok) { const e = await r.json().catch(() => ({}));
    throw new Error(e.error ? e.error.message : r.status); }
  return r;
}
async function register() {
  try { await api('POST', '/api/v1/auth/register',
    {username: $$('u').value, password: $$('p').value}); await login(); }
  catch (e) { log(e.message); }
}
async function login() {
  try {
    const r = await (await api('POST', '/api/v1/auth/login',
      {username: $$('u').value, password: $$('p').value})).json();
    token = r.token; localStorage.setItem('tok', token);
    $$('who').textContent = r.user.username; log('');
    $$('authPanel').style.display = 'none'; loadColls();
  } catch (e) { log(e.message); }
}
async function loadColls() {
  try {
    const cols = await (await api('GET', '/api/v1/collections')).json();
    $$('collList').innerHTML = cols.map(c =>
      `<div class="coll ${coll && coll.id===c.id ? 'active':''}"
        onclick='pick(${JSON.stringify(c)})'>${c.title}
        <div class="badge">${c.id}</div></div>`).join('');
  } catch (e) { log(e.message); }
}
function pick(c) { coll = c; chatId = null; loadColls(); loadDocs(); }
async function createColl() {
  try { await api('POST', '/api/v1/collections',
      {title: $$('newColl').value}); $$('newColl').value=''; loadColls(); }
  catch (e) { log(e.message); }
}
function tab(name) {
  for (const t of ['search','docs','chat']) {
    $$('pane-' + t).style.display = t === name ? '' : 'none';
    $$('tab-' + t).className = t === name ? 'on' : '';
  }
}
async function search() {
  if (!coll) return log('pick a collection');
  try {
    const r = await (await api('POST',
      `/api/v1/collections/${coll.id}/searches`,
      {query: $$('q').value, top_k: 10})).json();
    $$('hits').innerHTML = r.items.map(h =>
      `<div class="hit"><div class="meta">#${h.rank}
        score=${h.score.toFixed(4)} [${h.recall_type}]
        ${h.metadata.document_name || ''}</div>
        <div>${h.text.slice(0, 500)}</div></div>`).join('')
      || '<div class="badge">no results</div>';
  } catch (e) { log(e.message); }
}
async function upload() {
  if (!coll) return log('pick a collection');
  const fd = new FormData();
  for (const f of $$('file').files) fd.append('file', f);
  try { await api('POST', `/api/v1/collections/${coll.id}/documents`,
                  fd, true); loadDocs(); }
  catch (e) { log(e.message); }
}
async function loadDocs() {
  if (!coll) return;
  try {
    const docs = await (await api('GET',
      `/api/v1/collections/${coll.id}/documents`)).json();
    $$('docs').innerHTML = docs.map(d =>
      `<div class="hit"><b>${d.name}</b>
       <span class="badge">${d.status}</span>
       <button class="ghost" style="float:right"
         onclick="delDoc('${d.id}')">delete</button></div>`).join('')
      || '<div class="badge">no documents</div>';
  } catch (e) { log(e.message); }
}
async function delDoc(id) {
  try { await api('DELETE', `/api/v1/documents/${id}`); loadDocs(); }
  catch (e) { log(e.message); }
}
function addMsg(cls, text) {
  const div = document.createElement('div');
  div.className = 'msg ' + cls; div.textContent = text;
  $$('chatlog').appendChild(div); return div;
}
async function sendChat() {
  if (!coll) return log('pick a collection');
  const text = $$('chatmsg').value; $$('chatmsg').value = '';
  if (!chatId) {
    const c = await (await api('POST', '/api/v1/chats',
      {collection_ids: [coll.id]})).json();
    chatId = c.id;
  }
  addMsg('user', text);
  const out = addMsg('assistant', '');
  const r = await api('POST', `/api/v1/chats/${chatId}/completions`,
                      {message: text});
  const reader = r.body.getReader();
  const dec = new TextDecoder();
  let buf = '';
  for (;;) {
    const {done, value} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream: true});
    for (const frame of buf.split('\n\n').slice(0, -1)) {
      const ev = (frame.match(/^event: (.*)$/m) || [])[1];
      const data = (frame.match(/^data: (.*)$/m) || [])[1];
      if (ev === 'delta' && data) out.textContent += JSON.parse(data).text;
    }
    buf = buf.split('\n\n').slice(-1)[0];
  }
}
if (token) {
  api('GET', '/api/v1/users/me').then(async r => {
    $$('who').textContent = (await r.json()).username;
    $$('authPanel').style.display = 'none'; loadColls();
  }).catch(() => { token = ''; localStorage.removeItem('tok'); });
}
</script></body></html>
"""


def register_webui_routes(router: Router) -> None:
    async def index(req: Request) -> Response:
        return Response(
            status=200,
            headers={"Content-Type": "text/html; charset=utf-8"},
            body=PAGE.encode(),
        )

    router.add("GET", "/", index)
