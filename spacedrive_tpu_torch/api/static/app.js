let reqId = 0, pending = {}, subs = {}, subSpecs = [];
const wsProto = location.protocol === "https:" ? "wss" : "ws";
let ws = null, reconnectDelay = 500;
// wsReady always has a live resolver: awaiting rpc() calls parked
// during a reconnect wake on the SAME promise the next onopen resolves.
let wsReadyResolve = null;
let wsReady = new Promise(r => wsReadyResolve = r);

function connect() {
  ws = new WebSocket(`${wsProto}://${location.host}/rspc`);
  ws.onopen = () => {
    reconnectDelay = 500;
    // standing subscriptions survive reconnects (the standalone-client
    // contract: the UI must keep working across server restarts)
    for (const s of subSpecs) {
      const id = ++reqId; subs[id] = s.cb;
      ws.send(JSON.stringify({id, type: "subscription",
                              path: s.path, input: s.input}));
    }
    wsReadyResolve();
  };
  ws.onmessage = (m) => {
    const f = JSON.parse(m.data);
    if (f.type === "response" && pending[f.id]) {
      pending[f.id].resolve(f.result); delete pending[f.id];
    } else if (f.type === "error" && pending[f.id]) {
      pending[f.id].reject(new Error(f.message)); delete pending[f.id];
    } else if (f.type === "event" && subs[f.id]) {
      subs[f.id](f.data);
    }
  };
  ws.onclose = () => {
    for (const id in pending) {
      pending[id].reject(new Error("connection lost")); delete pending[id];
    }
    subs = {};
    // Park wsReady on a fresh promise NOW (resolver saved for the next
    // onopen): rpc() calls made during the backoff window suspend here
    // instead of sending into the closed socket.
    wsReady = new Promise(r => wsReadyResolve = r);
    toast(`reconnecting in ${Math.round(reconnectDelay / 1000)}s…`);
    setTimeout(connect, reconnectDelay);
    reconnectDelay = Math.min(reconnectDelay * 2, 15000);
  };
}
connect();
async function rpc(type, path, input) {
  await wsReady;
  const id = ++reqId;
  ws.send(JSON.stringify({id, type, path, input}));
  return new Promise((resolve, reject) => pending[id] = {resolve, reject});
}
const q = (p, i) => rpc("query", p, i);
const mut = (p, i) => rpc("mutation", p, i);
function sub(path, input, cb) {
  subSpecs.push({path, input, cb});
  if (ws && ws.readyState === 1) {  // otherwise onopen replays subSpecs
    const id = ++reqId;
    subs[id] = cb;
    ws.send(JSON.stringify({id, type: "subscription", path, input}));
  }
}
function subOnce(path, input, cb) {
  // NOT replayed on reconnect (device-code flows must not silently
  // restart server-side); caller's cb returns true to stop the stream.
  if (!ws || ws.readyState !== 1) { toast("not connected"); return; }
  const id = ++reqId;
  subs[id] = (data) => {
    if (cb(data)) {
      delete subs[id];
      ws.send(JSON.stringify({id, type: "subscriptionStop"}));
    }
  };
  ws.send(JSON.stringify({id, type: "subscription", path, input}));
}
function toast(msg) {
  const t = document.getElementById("toast");
  t.textContent = msg; t.style.display = "block";
  clearTimeout(t._h); t._h = setTimeout(() => t.style.display = "none", 3000);
}
const esc = (s) => String(s ?? "").replace(/[&<>"']/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
const fmtBytes = (n) => {
  n = Number(n) || 0;
  for (const u of ["B","KiB","MiB","GiB","TiB"]) {
    if (n < 1024 || u === "TiB") return n.toFixed(u==="B"?0:1)+" "+u;
    n /= 1024;
  }
};

let lib = null, loc = null, curPath = "/", view = "explorer";
let selected = null, tagFilter = null, favOnly = false, allTags = [];
let albumFilter = null, spaceFilter = null;  // object-grouping filters
let kindFilter = null;         // ObjectKind filter from the overview
let viewMode = "grid";         // grid | list | media (explorer modes)
let sortKey = null, sortDir = 1;  // list-view column sort
let selection = new Set();     // multi-select: file_path ids
let lastRows = [];             // rows rendered by the last browse()
let lastClickId = null;        // shift-range anchor
let clipboard = null;          // {op: "copy"|"cut", ids, locId}
let settingsLoc = null;        // location id open in per-location settings
let syncSubLib = null;         // library whose sync stream we watch

const TABS = [["overview","Overview"],
              ["explorer","Explorer"],["browse","Browse"],
              ["dups","Duplicates"],
              ["neardups","Near-dups"],["jobs","Jobs"],["p2p","P2P"],
              ["settings","Settings"]];
function renderTabs() {
  const el = document.getElementById("tabs"); el.innerHTML = "";
  for (const [id, label] of TABS) {
    const d = document.createElement("div");
    d.className = "tab" + (view === id ? " sel" : "");
    d.textContent = label;
    d.onclick = () => { view = id; renderTabs(); render(); };
    el.appendChild(d);
  }
}

// ---- Onboarding (create library → add location, the reference's
// interface/app/onboarding flow) ---------------------------------------
function showOnboarding() {
  if (document.getElementById("onboard")) return;
  const o = document.createElement("div");
  o.id = "onboard";
  o.innerHTML = `<div class="card">
    <h1>Welcome to spacedrive-tpu</h1>
    <p class="muted">A library is your private database of every file
      it indexes. Create one, then point it at a folder.</p>
    <h3>1 · Create your library</h3>
    <p><input id="oblib" placeholder="library name" value="My Library"
              style="width:100%"/></p>
    <h3>2 · Add a first location</h3>
    <p><input id="obloc" placeholder="/path/to/files (optional)"
              style="width:100%"/></p>
    <p style="text-align:right"><button id="obgo">Create</button></p>
    <div id="oberr" class="muted"></div>
  </div>`;
  document.body.appendChild(o);
  document.getElementById("obgo").onclick = async () => {
    const name = document.getElementById("oblib").value.trim();
    if (!name) return;
    try {
      const l = await mut("library.create", {name});
      lib = l.uuid;
      const path = document.getElementById("obloc").value.trim();
      if (path) {
        loc = await mut("locations.create", {library_id: lib, path});
        toast("indexing started");
      }
      o.remove(); loadAll();
    } catch (err) {
      document.getElementById("oberr").textContent = String(err);
    }
  };
}

async function loadLibs() {
  const libs = await q("library.list");
  if (!libs.length) showOnboarding();
  const el = document.getElementById("libs"); el.innerHTML = "";
  for (const l of libs) {
    const d = document.createElement("div");
    d.className = "item" + (lib === l.uuid ? " sel" : "");
    d.textContent = l.config ? l.config.name : l.name;
    d.onclick = () => { lib = l.uuid; loadAll(); };
    d.oncontextmenu = async (e) => {
      e.preventDefault();
      if (confirm(`delete library "${d.textContent}"?`)) {
        await mut("library.delete", {id: l.uuid});
        if (lib === l.uuid) lib = null;
        loadLibs();
      }
    };
    el.appendChild(d);
  }
  if (!lib && libs.length) { lib = libs[0].uuid; loadAll(); }
}
function loadAll() {
  loadLibs(); loadLocs(); loadTags(); loadGroupings();
  loadSaved(); loadStats(); render();
}

// ---- albums / spaces (object groupings over the reference's
// schema.prisma:389-411/448-477 models — it ships no UI for them) --
async function loadGroupings() {
  if (!lib) return;
  for (const kind of ["album", "space"]) {
    const rows = await q(`${kind}s.list`, {library_id: lib});
    const el = document.getElementById(kind + "s");
    el.innerHTML = "";
    for (const g of rows) {
      const d = document.createElement("span");
      const active = (kind === "album" ? albumFilter : spaceFilter)
        === g.id;
      d.className = "tagchip" + (active ? " on" : "");
      d.textContent = g.name +
        (g.object_count ? ` (${g.object_count})` : "");
      d.title = "click: filter · dblclick: rename · " +
        "right-click: delete";
      d.onclick = () => {
        if (kind === "album") {
          albumFilter = albumFilter === g.id ? null : g.id;
        } else {
          spaceFilter = spaceFilter === g.id ? null : g.id;
        }
        loadGroupings(); render();
      };
      d.ondblclick = async () => {
        const name = prompt(`${kind} name`, g.name);
        if (!name) return;
        await mut(`${kind}s.update`,
                  {library_id: lib, id: g.id, name});
        loadGroupings();
      };
      d.oncontextmenu = async (e) => {
        e.preventDefault();
        if (confirm(`delete ${kind} \"${g.name}\"?`)) {
          await mut(`${kind}s.delete`, {library_id: lib, id: g.id});
          if (kind === "album" && albumFilter === g.id)
            albumFilter = null;
          if (kind === "space" && spaceFilter === g.id)
            spaceFilter = null;
          loadGroupings(); render();
        }
      };
      el.appendChild(d);
    }
  }
}

// ---- saved searches (stored in library preferences, the reference's
// interface persists view state the same way) --------------------------
async function getSavedSearches() {
  const prefs = await q("preferences.get", {library_id: lib});
  try { return JSON.parse(prefs.saved_searches || "{}"); }
  catch (e) { return {}; }
}
function putSavedSearches(saved) {
  return mut("preferences.update", {library_id: lib,
    values: {saved_searches: JSON.stringify(saved)}});
}
async function loadSaved() {
  if (!lib) return;
  const saved = await getSavedSearches();
  const el = document.getElementById("saved"); el.innerHTML = "";
  for (const [name, spec] of Object.entries(saved)) {
    const d = document.createElement("div");
    d.className = "item"; d.textContent = "🔖 " + name;
    d.title = "click: run · right-click: delete";
    d.onclick = () => {
      document.getElementById("search").value = spec.q || "";
      tagFilter = spec.tag ?? null;
      kindFilter = spec.kind ?? null;
      if (spec.loc != null) loc = spec.loc;
      view = "explorer"; renderTabs(); render();
    };
    d.oncontextmenu = async (e) => {
      e.preventDefault();
      delete saved[name];
      await putSavedSearches(saved);
      loadSaved();
    };
    el.appendChild(d);
  }
}
document.getElementById("savesearch").onclick = async () => {
  if (!lib) return;
  const name = prompt("name this search"); if (!name) return;
  const saved = await getSavedSearches();
  saved[name] = {q: document.getElementById("search").value.trim(),
                 tag: tagFilter, kind: kindFilter, loc};
  await putSavedSearches(saved);
  loadSaved();
};

async function loadLocs() {
  if (!lib) return;
  const locs = await q("locations.list", {library_id: lib});
  const el = document.getElementById("locs"); el.innerHTML = "";
  for (const l of locs) {
    const d = document.createElement("div");
    d.className = "item" + (loc === l.id ? " sel" : "");
    d.textContent = l.name || l.path;
    const gear = document.createElement("span");
    gear.className = "gear"; gear.textContent = "⚙";
    gear.title = "location settings";
    gear.onclick = (e) => {
      e.stopPropagation();
      settingsLoc = l.id; view = "locsettings"; renderTabs(); render();
    };
    d.prepend(gear);
    d.title = "click: open · right-click: rescan · shift-click: delete";
    d.oncontextmenu = async (e) => {
      e.preventDefault();
      await mut("locations.fullRescan", {library_id: lib, location_id: l.id});
      toast("rescan started");
    };
    d.onclick = async (e) => {
      if (e.shiftKey) {
        if (confirm(`remove location ${d.textContent}?`)) {
          await mut("locations.delete", {library_id: lib, id: l.id});
          if (loc === l.id) loc = null;
          loadLocs();
        }
        return;
      }
      kindFilter = null;
      loc = l.id; curPath = "/"; view = "explorer";
      renderTabs(); render(); loadLocs();
    };
    el.appendChild(d);
  }
}

async function loadTags() {
  if (!lib) return;
  const withObjects = await q("tags.getWithObjects", {library_id: lib});
  allTags = withObjects;
  const el = document.getElementById("tags"); el.innerHTML = "";
  for (const t of allTags) {
    const d = document.createElement("span");
    d.className = "tagchip" + (tagFilter === t.id ? " on" : "");
    const nObj = (t.object_ids || []).length;
    d.textContent = t.name + (nObj ? ` (${nObj})` : "");
    d.title = "click: filter · dblclick: edit · right-click: delete";
    if (t.color) d.style.borderLeft = `4px solid ${esc(t.color)}`;
    d.onclick = () => {
      tagFilter = tagFilter === t.id ? null : t.id; loadTags(); render();
    };
    d.ondblclick = async () => {
      const cur = await q("tags.get", {library_id: lib, id: t.id});
      const name = prompt("tag name", cur.name); if (!name) return;
      const color = prompt("color (css)", cur.color || "") || null;
      await mut("tags.update", {library_id: lib, id: t.id, name, color});
      loadTags();
    };
    d.oncontextmenu = async (e) => {
      e.preventDefault();
      if (confirm(`delete tag "${t.name}"?`)) {
        await mut("tags.delete", {library_id: lib, id: t.id});
        if (tagFilter === t.id) tagFilter = null;
        loadTags();
      }
    };
    el.appendChild(d);
  }
}

async function loadStats() {
  if (!lib) return;
  const s = await q("library.statistics", {library_id: lib});
  document.getElementById("stats").innerHTML =
    `<div class="kv">paths: <b>${s.total_paths ?? s.file_paths ?? "?"}</b></div>` +
    `<div class="kv">objects: <b>${s.total_objects ?? s.objects ?? "?"}</b></div>` +
    `<div class="kv">bytes: <b>${fmtBytes(s.total_bytes_used ?? s.total_bytes ?? 0)}</b></div>`;
}

function render() {
  document.getElementById("inspector").style.display = "none";
  hideCtx(); closePreview();
  if (view !== "explorer") { vg = null; cursorIdx = null; }
  ({overview: renderOverview,
    explorer: browse, browse: renderEphemeral, dups: renderDups,
    neardups: renderNearDups,
    jobs: renderJobs, p2p: renderP2P, settings: renderSettings,
    locsettings: renderLocSettings}[view])();
}

// ---- Overview landing page (interface/app/$libraryId/overview:
// categories + statistics + recents + node card) -----------------------
const KIND_NAMES = {0:"Unknown",1:"Document",2:"Folder",3:"Text",
  4:"Package",5:"Image",6:"Audio",7:"Video",8:"Archive",9:"Executable",
  10:"Alias",11:"Encrypted",12:"Key",13:"Link",14:"WebPage",15:"Widget",
  16:"Album",17:"Book",18:"Code",19:"Database",20:"Font",21:"Mesh",
  22:"Config",23:"Dotfile",24:"Screenshot",25:"Label"};
async function renderOverview() {
  const main = document.getElementById("main");
  if (!lib) { main.innerHTML =
    "<div class='muted'>create a library first</div>"; return; }
  const [stats, cats, locs, online, info, nstate, active, nlocs,
         nObjects] = await Promise.all([
    q("library.statistics", {library_id: lib}),
    q("categories.list", {library_id: lib}),
    q("locations.list", {library_id: lib}),
    q("locations.online", {library_id: lib}),
    q("buildInfo"),
    q("nodeState"),
    q("jobs.isActive", {library_id: lib}),
    q("nodes.listLocations", {library_id: lib}),
    q("search.objectsCount", {library_id: lib, filter: {}}),
  ]);
  const onlineSet = new Set(online);
  const tiles = [
    ["Objects", nObjects],
    ["Unique bytes", fmtBytes(+stats.total_unique_bytes || 0)],
    ["Total bytes", fmtBytes(+stats.total_bytes_used || 0)],
    ["Capacity", fmtBytes(+stats.total_bytes_capacity || 0)],
    ["Locations", nlocs.length],
    ["Jobs", active ? "running" : "idle"],
  ];
  const catCells = Object.entries(cats)
    .filter(([, n]) => n > 0)
    .sort((a, b) => b[1] - a[1])
    .map(([k, n]) => `<div class="cat" data-kind="${esc(k)}">
       <b>${n}</b> ${esc(KIND_NAMES[k] ?? k)}</div>`).join("");
  main.innerHTML = `<h1>Overview</h1>
    <div id="tiles">` + tiles.map(([k, v]) =>
      `<div class="tile"><div class="muted">${esc(k)}</div>
       <b>${esc(v)}</b></div>`).join("") + `</div>
    <h2>Categories</h2>
    <div id="cats">${catCells ||
      "<span class='muted'>nothing indexed yet</span>"}</div>
    <h2>Locations</h2>
    <div id="ovlocs">` + locs.map(l => `
      <div class="item ovloc" data-lid="${l.id}">
        ${onlineSet.has(l.id) ? "🟢" : "⚫"} ${esc(l.name || l.path)}
        <span class="muted">${esc(l.path || "")}</span></div>`).join("") +
    `</div>
    <h2>This node</h2>
    <div class="kv">name: <b>${esc(nstate.name)}</b>
      · version <b>${esc(info.version)}</b></div>
    <div class="kv">data: <b>${esc(nstate.data_path)}</b></div>`;
  document.querySelectorAll(".ovloc").forEach(el => el.onclick = () => {
    loc = +el.dataset.lid; curPath = "/"; kindFilter = null;
    view = "explorer"; renderTabs(); render();
  });
  document.querySelectorAll(".cat").forEach(el => el.onclick = () => {
    view = "explorer"; renderTabs();
    kindFilter = +el.dataset.kind; render();
  });
}

// ---- Ephemeral browsing (non-indexed paths, non_indexed.rs) ----------
let ephPath = "/";
async function renderEphemeral() {
  const main = document.getElementById("main");
  main.innerHTML = `
    <h1>Browse (not indexed)</h1>
    <p><input id="ephpath" value="${esc(ephPath)}" style="width:60%"/>
       <button id="ephgo">go</button>
       <button id="ephmkdir" class="ghost">+ folder</button>
       <span class="muted">any directory on this node — nothing is
       written to the library</span></p>
    <div id="ephmeta" class="muted"></div>
    <div id="grid"></div>`;
  const go = async () => {
    ephPath = document.getElementById("ephpath").value.trim() || "/";
    let entries;
    try {
      entries = await q("search.ephemeralPaths",
                        {path: ephPath, with_thumbnails: true});
    } catch (e) { toast(String(e)); return; }
    const grid = document.getElementById("grid");
    grid.innerHTML = "";
    if (ephPath !== "/") {
      grid.appendChild(cell({name: "..", is_dir: 1}, () => {
        ephPath = ephPath.replace(/\/[^/]+\/?$/, "") || "/";
        document.getElementById("ephpath").value = ephPath;
        go();
      }));
    }
    for (const e of entries) {
      const r = {name: e.name, extension: e.extension,
                 is_dir: e.is_dir, cas_id: e.cas_id, id: -1};
      grid.appendChild(cell(r, async () => {
        if (e.is_dir) {
          ephPath = e.path;
          document.getElementById("ephpath").value = ephPath;
          go();
        } else {
          let md = null;
          try {
            md = await q("files.getEphemeralMediaData", {path: e.path});
          } catch (err) { /* unreadable */ }
          document.getElementById("ephmeta").textContent =
            `${e.name}: ` + (md ? Object.entries(md)
              .map(([k, v]) => `${k}=${v}`).join(" · ")
              : "no media metadata");
        }
      }));
    }
  };
  document.getElementById("ephgo").onclick = go;
  document.getElementById("ephmkdir").onclick = async () => {
    const name = prompt("folder name"); if (!name) return;
    await mut("files.createEphemeralFolder", {path: ephPath, name});
    go();
  };
  document.getElementById("ephpath").onkeydown =
    (e) => { if (e.key === "Enter") go(); };
  go();
}

// ---- Explorer --------------------------------------------------------
// ---- virtualized explorer --------------------------------------------
// The engine browses 1M-file libraries; the old renderer fetched a hard
// take:400 and built a DOM node per row. Now the result set is WINDOWED
// (search.paths skip/take — the server orders and filters, so absolute
// indices are stable) and only the viewport ± overscan rows exist in
// the DOM, the same shape as the reference Explorer's
// @tanstack/react-virtual grids (interface/app/$libraryId/Explorer/).
const VWIN = 200;        // rows per fetched window (≤ server take cap)
// Browsers clamp element heights (~17.9M px in Firefox); above this
// the spacer stays capped and scrollTop maps into virtual row space
// by ratio, so a 1M-row list (26M px) stays fully reachable.
const VG_MAX_SPACER = 12_000_000;
const MEDIA_EXTS = ["png","jpg","jpeg","gif","webp","bmp","tiff",
  "tif","heic","heif","avif","svg","svgz","pdf","avi","mp4","mkv",
  "mov","webm"];
let vg = null;           // virtual-grid state for the current browse
let vgResizeObs = null;  // one observer, re-pointed per browse
let cursorIdx = null;    // keyboard cursor as an ABSOLUTE index
let lastClickIdx = null; // shift-range anchor as an ABSOLUTE index

function vgDims() {
  if (viewMode === "list") return {cellW: 0, cellH: 26, listMode: true};
  if (viewMode === "media")
    return {cellW: 188, cellH: 178, listMode: false};
  return {cellW: 116, cellH: 126, listMode: false};
}
function vgCols() {
  if (!vg) return 1;
  const {cellW, listMode} = vgDims();
  if (listMode) return 1;
  return Math.max(1, Math.floor((vg.wrap.clientWidth - 8) / cellW));
}

async function browse() {
  const main = document.getElementById("main");
  vg = null; cursorIdx = null;
  if (!lib || (loc == null && kindFilter == null
               && albumFilter == null && spaceFilter == null)) {
    main.innerHTML =
      "<div class='muted'>create a library and add a location</div>";
    return;
  }
  const searchText = document.getElementById("search").value.trim();
  // kind drill-down from the overview is LIBRARY-wide (matching the
  // tile's count); normal browsing scopes to the selected location.
  // album/space/kind drill-downs are LIBRARY-wide; normal browsing
  // scopes to the selected location + current folder
  const libraryWide = kindFilter != null || albumFilter != null
    || spaceFilter != null;
  const filter = kindFilter != null ? {object_kind: [kindFilter]}
    : (libraryWide ? {} : {location_id: loc});
  if (albumFilter != null) filter.album_id = albumFilter;
  if (spaceFilter != null) filter.space_id = spaceFilter;
  if (searchText) filter.search = searchText;
  else if (!libraryWide) filter.materialized_path = curPath;
  if (tagFilter != null) filter.tags = [tagFilter];
  // Every narrowing is SERVER-side: client-side filtering would leave
  // holes in the windows and shift absolute indices.
  if (favOnly) filter.favorite = true;
  if (viewMode === "media") filter.extensions = MEDIA_EXTS;
  const order = (viewMode === "list" && sortKey)
    ? {field: sortKey, desc: sortDir < 0} : null;
  const count = await q("search.pathsCount", {library_id: lib, filter});
  const kindChip = kindFilter == null ? "" :
    ` · <span class="tagchip on" id="kindchip">kind: ` +
    `${esc(KIND_NAMES[kindFilter] ?? kindFilter)} ✕</span>`;
  const showUp = !searchText && !libraryWide && curPath !== "/";
  const upBtn = showUp
    ? `<span class="tagchip" id="upbtn">⬆ ..</span> · ` : "";
  main.innerHTML =
    `<div class="muted" style="margin-bottom:10px">${upBtn}` +
    `location ${loc} · ` +
    `${searchText ? `search "${esc(searchText)}"` : esc(curPath)} · ` +
    `${count} paths${kindChip}</div>` +
    (viewMode === "list" ? listHeaderHtml() : "") +
    `<div id="gridwrap"><div id="grid" class="virt` +
    `${viewMode === "media" ? " media" : ""}` +
    `${viewMode === "list" ? " vlist" : ""}"></div></div>`;
  const chip = document.getElementById("kindchip");
  if (chip) chip.onclick = () => { kindFilter = null; browse(); };
  const up = document.getElementById("upbtn");
  if (up) up.onclick = () => {
    curPath = curPath.replace(/[^/]+\/$/, ""); clearSel(); browse();
  };
  if (viewMode === "list") wireListHeader();
  lastRows = new Array(count);  // sparse: windows fill as they load
  vg = {count, filter, order,
        wrap: document.getElementById("gridwrap"),
        grid: document.getElementById("grid"),
        fetched: new Set(), inflight: new Map(), pool: new Map()};
  vg.wrap.onscroll = () => vgUpdate();
  // Re-layout when the scroller's width changes without a scroll
  // (inspector open/close, window resize) — vgUpdate detects the new
  // column count and rebuilds the pool.
  if (window.ResizeObserver) {
    if (!vgResizeObs) vgResizeObs = new ResizeObserver(() => vgUpdate());
    vgResizeObs.disconnect();
    vgResizeObs.observe(vg.wrap);
  }
  vgUpdate();
}

function listHeaderHtml() {
  const lbl = (k) => k + (sortKey === k
    ? (sortDir > 0 ? " ↑" : " ↓") : "");
  return `<div id="listhdr"><span></span>` +
    ["name", "kind", "size", "modified"].map(k =>
      `<span class="lh" data-k="${k}">${lbl(k)}</span>`).join("") +
    `</div>`;
}
function wireListHeader() {
  document.querySelectorAll("#listhdr .lh").forEach(el => {
    el.onclick = () => {   // server-side re-sort, windows refetch
      const k = el.dataset.k;
      sortDir = sortKey === k ? -sortDir : 1;
      sortKey = k;
      browse();
    };
  });
}

function vgUpdate() {
  if (!vg || !vg.wrap.isConnected) return;
  const {cellW, cellH, listMode} = vgDims();
  const cols = vgCols();
  if (vg.renderedCols !== undefined && vg.renderedCols !== cols) {
    // Column count changed (inspector opened, window resized): pooled
    // cells hold absolute positions computed with the OLD count —
    // drop them all so this pass re-lays out at the new geometry.
    for (const el of vg.pool.values()) el.remove();
    vg.pool.clear();
  }
  vg.renderedCols = cols;
  const rows = Math.ceil(vg.count / cols);
  const fullH = Math.max(rows * cellH, 1);
  const spacerH = Math.min(fullH, VG_MAX_SPACER);
  vg.grid.style.height = spacerH + "px";
  const view = vg.wrap.clientHeight;
  const scale = (fullH > spacerH && spacerH > view)
    ? (fullH - view) / (spacerH - view) : 1;
  const vTop = vg.wrap.scrollTop * scale;  // virtual pixel offset
  const base = vg.wrap.scrollTop - vTop;   // virtual→spacer shift
  vg.scale = scale;
  const y0 = vTop, y1 = vTop + view;
  const r0 = Math.max(0, Math.floor(y0 / cellH) - 3);
  const r1 = Math.min(Math.max(rows - 1, 0), Math.ceil(y1 / cellH) + 3);
  const i0 = r0 * cols;
  const i1 = Math.min(vg.count - 1, (r1 + 1) * cols - 1);
  for (let w = Math.floor(i0 / VWIN); w <= Math.floor(i1 / VWIN); w++)
    vgFetch(w);
  for (const [idx, el] of [...vg.pool]) {
    if (idx < i0 || idx > i1) { el.remove(); vg.pool.delete(idx); }
    else if (scale !== 1) {   // compressed spacer: tops shift per scroll
      el.style.top = (base + Math.floor(idx / cols) * cellH) + "px";
    }
  }
  for (let i = i0; i <= i1; i++) {
    if (vg.pool.has(i)) continue;
    const r = lastRows[i];
    if (!r) continue;    // window in flight; vgFetch re-renders
    const el = listMode ? listRow(r) : cell(r, null);
    el.style.position = "absolute";
    el.style.top = (base + Math.floor(i / cols) * cellH) + "px";
    if (listMode) {
      el.style.left = "0"; el.style.right = "0";
    } else {
      el.style.left = ((i % cols) * cellW) + "px";
    }
    el.dataset.idx = i;
    vg.grid.appendChild(el);
    vg.pool.set(i, el);
  }
}

function vgFetch(w) {
  if (!vg || vg.fetched.has(w)) return Promise.resolve();
  if (vg.inflight.has(w)) return vg.inflight.get(w);
  const mine = vg;
  const p = q("search.paths", {
    library_id: lib, skip: w * VWIN, take: VWIN, filter: mine.filter,
    ...(mine.order ? {order: mine.order} : {}),
  }).then(res => {
    if (vg !== mine) return;    // navigated away mid-flight
    (res.items || []).forEach((it, j) => { lastRows[w * VWIN + j] = it; });
    mine.fetched.add(w);
    mine.inflight.delete(w);
    vgUpdate();
  }).catch(() => {
    // transient failure (server restart, network blip): clear the
    // inflight marker and retry shortly — otherwise the very first
    // viewport stays blank forever with no scroll to re-trigger it
    mine.inflight.delete(w);
    setTimeout(() => { if (vg === mine) vgUpdate(); }, 1000);
  });
  mine.inflight.set(w, p);
  return p;
}

// Scroll an absolute index into view, fetch its window, select it.
async function selectIndex(i) {
  if (!vg || !vg.count) return;
  i = Math.max(0, Math.min(vg.count - 1, i));
  cursorIdx = i;
  const {cellH} = vgDims();
  const cols = vgCols();
  const scale = vg.scale || 1;
  const top = Math.floor(i / cols) * cellH;  // virtual px
  const vTop = vg.wrap.scrollTop * scale;
  if (top < vTop) vg.wrap.scrollTop = top / scale;
  else if (top + cellH > vTop + vg.wrap.clientHeight)
    vg.wrap.scrollTop =
      (top + cellH - vg.wrap.clientHeight) / scale;
  await vgFetch(Math.floor(i / VWIN));
  const r = lastRows[i];
  if (!r) return;
  selection.clear(); selection.add(r.id); lastClickId = r.id;
  vgUpdate(); updateSelClasses();
  if (previewRow) openPreview(r);
}

function openEntry(r) {
  if (r.is_dir) {
    curPath = r.materialized_path + r.name + "/";
    document.getElementById("search").value = ""; clearSel(); browse();
  } else inspect(r);
}

// ---- multi-select + context menu -------------------------------------
function clearSel() {
  selection.clear(); lastClickId = null; lastClickIdx = null;
}
function updateSelClasses() {
  // selection changes repaint in place — no refetch, no DOM rebuild
  document.querySelectorAll("[data-fpid]").forEach(el =>
    el.classList.toggle("sel", selection.has(+el.dataset.fpid)));
}
function entryClick(r, e) {
  // absolute keyboard cursor: the rendered cell carries its index
  // (dataset.idx, set by vgUpdate) — O(1) vs an O(count) indexOf over
  // the sparse array at 1M rows
  const el = e && e.currentTarget;
  const idx = (el && el.dataset && el.dataset.idx !== undefined)
    ? +el.dataset.idx : null;
  cursorIdx = idx;
  if (e.shiftKey && lastClickIdx != null && idx != null) {
    // range select between the two ANCHOR INDICES — O(range), no
    // O(count) scan of the sparse array (holes stay unselected)
    for (let k = Math.min(lastClickIdx, idx);
         k <= Math.max(lastClickIdx, idx); k++)
      if (lastRows[k]) selection.add(lastRows[k].id);
    updateSelClasses();
  } else if (e.ctrlKey || e.metaKey) {
    selection.has(r.id) ? selection.delete(r.id) : selection.add(r.id);
    lastClickId = r.id; lastClickIdx = idx;
    updateSelClasses();
  } else {
    selection.clear(); selection.add(r.id); lastClickId = r.id;
    lastClickIdx = idx;
    updateSelClasses();
    openEntry(r);
  }
}
function selRows() {
  const rows = lastRows.filter(r => selection.has(r.id) && !r.is_dir);
  return rows.length ? rows : [];
}
function hideCtx() {
  const m = document.getElementById("ctxmenu");
  if (m) m.style.display = "none";
}
document.addEventListener("click", hideCtx);

// ---- quick preview overlay (the reference's space-bar QuickPreview,
// interface/app/$libraryId/Explorer/QuickPreview) ----------------------
let previewRow = null;
const IMG_EXT = new Set(["png","jpg","jpeg","gif","webp","bmp","svg"]);
function closePreview() {
  const p = document.getElementById("preview");
  if (p) p.style.display = "none";
  previewRow = null;
}
async function openPreview(r) {
  if (!r || r.is_dir) return;
  previewRow = r;
  const p = document.getElementById("preview");
  const ext = (r.extension || "").toLowerCase();
  const src = IMG_EXT.has(ext)
    ? `/spacedrive/file/${lib}/${loc}/${r.id}`
    : (r.cas_id ? `/spacedrive/thumbnail/${r.cas_id}.webp` : null);
  let pathLine = "";
  try {
    const full = await q("files.getPath", {library_id: lib, id: r.id});
    if (full) pathLine = `<div class="kv pvpath">${esc(full)}</div>`;
  } catch (e) { /* ephemeral rows have no id */ }
  p.innerHTML = `<div id="pvbody">
    <div id="pvmedia">${src
      ? `<img src="${src}" onerror="this.replaceWith('🗎')"/>` : "🗎"}</div>
    <div id="pvmeta">
      <h1>${esc(r.name)}${r.extension ? "." + esc(r.extension) : ""}</h1>
      <div class="kv">size: <b>${fmtBytes(r.size_in_bytes || 0)}</b></div>
      <div class="kv">modified: <b>${r.date_modified
        ? new Date(r.date_modified * 1000).toISOString() : "?"}</b></div>
      <div class="kv">cas: <b>${esc(r.cas_id || "—")}</b></div>
      ${pathLine}
      <div class="muted">space/esc close · ←/→ navigate</div>
    </div></div>`;
  p.style.display = "flex";
  p.onclick = (e) => { if (e.target === p) closePreview(); };
  if (r.object_id != null)
    mut("files.updateAccessTime",
        {library_id: lib, ids: [r.object_id]}).catch(() => {});
}
function previewStep(delta) {
  const files = lastRows.filter(x => !x.is_dir);
  if (!files.length || !previewRow) return;
  const i = files.findIndex(x => x.id === previewRow.id);
  const next = files[(i + delta + files.length) % files.length];
  selection.clear(); selection.add(next.id); lastClickId = next.id;
  updateSelClasses();
  openPreview(next);
}

// ---- keyboard model: arrows/enter/del/space in grid and list ---------
function gridColumns() {
  if (vg) return vgCols();
  const g = document.getElementById("grid");
  if (!g || viewMode === "list") return 1;
  const cols = getComputedStyle(g).gridTemplateColumns.split(" ").length;
  return Math.max(1, cols);
}
function moveCursor(delta) {
  // Absolute-index navigation over the virtual window: the target row
  // may not be fetched yet — selectIndex scrolls there, fetches its
  // window, then selects.
  if (!vg || !vg.count) return;
  if (cursorIdx == null) { selectIndex(delta > 0 ? 0 : vg.count - 1); return; }
  selectIndex(cursorIdx + delta);
}
document.addEventListener("keydown", (e) => {
  if (e.key === "Escape") {
    closePreview(); clearSel(); hideCtx(); updateSelClasses(); return;
  }
  const tag = (document.activeElement || {}).tagName;
  if (tag === "INPUT" || tag === "TEXTAREA" || view !== "explorer") return;
  if (e.key === " ") {
    e.preventDefault();
    if (previewRow) { closePreview(); return; }
    const r = lastRows.find(x => x && selection.has(x.id) && !x.is_dir);
    if (r) openPreview(r);
  } else if (e.key === "ArrowRight") {
    e.preventDefault();
    previewRow ? previewStep(1) : moveCursor(1);
  } else if (e.key === "ArrowLeft") {
    e.preventDefault();
    previewRow ? previewStep(-1) : moveCursor(-1);
  } else if (e.key === "ArrowDown") {
    e.preventDefault(); moveCursor(gridColumns());
  } else if (e.key === "ArrowUp") {
    e.preventDefault(); moveCursor(-gridColumns());
  } else if (e.key === "Enter") {
    const r = lastRows.find(x => x && selection.has(x.id));
    if (r) openEntry(r);
  } else if (e.key === "Delete") {
    const rows = selRows();
    if (!rows.length || !confirm(`delete ${rows.length} file(s)?`)) return;
    mut("files.deleteFiles", {library_id: lib, location_id: loc,
      file_path_ids: rows.map(x => x.id)}).then(() => {
        toast("deleting…"); clearSel(); setTimeout(browse, 400);
      });
  } else if ((e.ctrlKey || e.metaKey) && e.key.toLowerCase() === "a") {
    e.preventDefault();
    lastRows.forEach(r => selection.add(r.id));  // loaded windows only
    updateSelClasses();
  }
});
function showCtx(r, e) {
  e.preventDefault();
  if (!selection.has(r.id)) {
    selection.clear(); selection.add(r.id); lastClickId = r.id;
    updateSelClasses();
  }
  const m = document.getElementById("ctxmenu");
  const rows = selRows();
  const n = rows.length;
  // Directory-only selection: file operations have nothing to act on,
  // so offer navigation alone instead of "(0)" no-op actions.
  const items = n === 0 ? [
    ["Open", () => openEntry(r)],
    ["Rescan this folder", async () => {
       await mut("locations.subPathRescan", {library_id: lib,
         location_id: loc, sub_path: curPath});
       toast("rescanning…"); }],
  ] : [
    ["Open / inspect", () => openEntry(r)],
    ["Preview (space)", () => { const f = selRows()[0];
       if (f) openPreview(f); }],
    ["Copy path", async () => {
       const full = await q("files.getPath", {library_id: lib, id: r.id});
       if (full && navigator.clipboard)
         navigator.clipboard.writeText(full).catch(() => {});
       toast(full || "no path"); }],
    ["sep"],
    [`Copy (${n})`, () => { clipboard = {op: "copy",
       ids: rows.map(x => x.id), locId: loc}; pasteBtn(); }],
    [`Cut (${n})`, () => { clipboard = {op: "cut",
       ids: rows.map(x => x.id), locId: loc}; pasteBtn(); }],
    [`Duplicate (${n})`, async () => {
       await mut("files.duplicateFiles", {library_id: lib,
         location_id: loc, file_path_ids: rows.map(x => x.id)});
       toast("duplicating…"); }],
    ["sep"],
    [`★ Favorite (${n})`, async () => {
       for (const x of rows) if (x.object_id != null)
         await mut("files.setFavorite",
                   {library_id: lib, id: x.object_id, favorite: true});
       toast("favorited"); }],
    [`Tag… (${n})`, async () => {
       const nm = prompt("tag name" + (allTags.length
         ? ` (existing: ${allTags.map(t => t.name).join(", ")})` : ""));
       if (!nm) return;
       let t = allTags.find(x => x.name === nm);
       if (!t) t = await mut("tags.create",
                             {library_id: lib, name: nm, color: null});
       for (const x of rows) if (x.object_id != null)
         await mut("tags.assign", {library_id: lib, tag_id: t.id,
                                   object_id: x.object_id});
       toast(`tagged ${n}`); loadTags(); }],
    [`Add to album… (${n})`, async () => {
       const albums = await q("albums.list", {library_id: lib});
       const nm = prompt("album name" + (albums.length
         ? ` (existing: ${albums.map(a => a.name).join(", ")})` : ""));
       if (!nm) return;
       let a2 = albums.find(x => x.name === nm);
       if (!a2) a2 = await mut("albums.create",
                               {library_id: lib, name: nm});
       const ids = rows.map(x => x.object_id).filter(v => v != null);
       await mut("albums.addObjects",
                 {library_id: lib, id: a2.id, object_ids: ids});
       toast(`added ${ids.length} to ${nm}`); loadGroupings(); }],
    [`Add to space… (${n})`, async () => {
       const sps = await q("spaces.list", {library_id: lib});
       const nm = prompt("space name" + (sps.length
         ? ` (existing: ${sps.map(s => s.name).join(", ")})` : ""));
       if (!nm) return;
       let sp = sps.find(x => x.name === nm);
       if (!sp) sp = await mut("spaces.create",
                               {library_id: lib, name: nm});
       const ids = rows.map(x => x.object_id).filter(v => v != null);
       await mut("spaces.addObjects",
                 {library_id: lib, id: sp.id, object_ids: ids});
       toast(`added ${ids.length} to ${nm}`); loadGroupings(); }],
    [`Validate (${n})`, async () => {
       await mut("jobs.objectValidator",
                 {library_id: lib, id: loc, mode: "fill"});
       toast("validator started"); }],
    ["Convert image…", async () => {
       const exts = await q("files.getConvertableImageExtensions");
       const to = prompt(`convert to (${exts.join(", ")})`);
       if (!to || !exts.includes(to.toLowerCase())) return;
       for (const x of selRows())
         await mut("files.convertImage", {library_id: lib,
           file_path_id: x.id, to_extension: to.toLowerCase()});
       toast("converted"); setTimeout(browse, 400); }],
    [`Clear access time (${n})`, async () => {
       const ids = selRows().map(x => x.object_id).filter(v => v != null);
       if (ids.length)
         await mut("files.removeAccessTime", {library_id: lib, ids});
       toast("cleared"); }],
    ["sep"],
    [`Delete (${n})`, async () => {
       if (!confirm(`delete ${n} file(s)?`)) return;
       await mut("files.deleteFiles", {library_id: lib, location_id: loc,
         file_path_ids: rows.map(x => x.id)});
       toast("deleting…"); clearSel();
       setTimeout(browse, 400); }],
    [`Erase securely (${n})`, async () => {
       if (!confirm(`overwrite + delete ${n} file(s)? irreversible`))
         return;
       await mut("files.eraseFiles", {library_id: lib, location_id: loc,
         file_path_ids: rows.map(x => x.id), passes: 1});
       toast("erasing…"); clearSel();
       setTimeout(browse, 600); }],
    ["sep"],
    [`Encrypt… (${n})`, async () => {
       const pw = prompt("encryption password"); if (!pw) return;
       await mut("files.encryptFiles", {library_id: lib,
         location_id: loc, file_path_ids: rows.map(x => x.id),
         password: pw});
       toast("encrypting…"); setTimeout(browse, 600); }],
    [`Decrypt… (${n})`, async () => {
       const pw = prompt("decryption password"); if (!pw) return;
       await mut("files.decryptFiles", {library_id: lib,
         location_id: loc, file_path_ids: rows.map(x => x.id),
         password: pw});
       toast("decrypting…"); setTimeout(browse, 600); }],
  ];
  m.innerHTML = "";
  for (const [label, fn] of items) {
    if (label === "sep") {
      const s = document.createElement("div"); s.className = "sep";
      m.appendChild(s); continue;
    }
    const d = document.createElement("div");
    d.className = "mi"; d.textContent = label;
    d.onclick = (ev) => { ev.stopPropagation(); hideCtx(); fn(); };
    m.appendChild(d);
  }
  m.style.left = Math.min(e.clientX, innerWidth - 180) + "px";
  m.style.top = Math.min(e.clientY, innerHeight - items.length * 28) + "px";
  m.style.display = "block";
}
function pasteBtn() {
  const b = document.getElementById("pastebtn");
  b.style.display = clipboard ? "" : "none";
  if (clipboard) b.textContent =
    `paste ${clipboard.ids.length} (${clipboard.op})`;
}
async function doPaste() {
  if (!clipboard || loc == null) return;
  const rel = curPath === "/" ? "" : curPath.slice(1);
  const input = {library_id: lib, source_location_id: clipboard.locId,
    sources_file_path_ids: clipboard.ids, target_location_id: loc,
    target_location_relative_directory_path: rel};
  await mut(clipboard.op === "cut" ? "files.cutFiles" : "files.copyFiles",
            input);
  toast(clipboard.op === "cut" ? "moving…" : "copying…");
  if (clipboard.op === "cut") clipboard = null;
  pasteBtn();
  setTimeout(browse, 500);
}

// ---- drag & drop: drag files onto a folder to move them --------------
function wireDnD(el, r) {
  if (!r.is_dir) {
    el.draggable = true;
    el.ondragstart = (e) => {
      if (!selection.has(r.id)) {
        selection.clear(); selection.add(r.id); updateSelClasses();
      }
      e.dataTransfer.setData("text/sdtpu-ids",
        JSON.stringify(selRows().map(x => x.id)));
      e.dataTransfer.effectAllowed = "move";
    };
  } else {
    el.ondragover = (e) => { e.preventDefault(); el.style.outline =
      "2px dashed #3b82f6"; };
    el.ondragleave = () => { el.style.outline = ""; };
    el.ondrop = async (e) => {
      e.preventDefault(); el.style.outline = "";
      let ids;
      try { ids = JSON.parse(e.dataTransfer.getData("text/sdtpu-ids")); }
      catch { return; }
      if (!ids || !ids.length) return;
      const rel = (r.materialized_path + r.name + "/").replace(/^\//, "");
      await mut("files.cutFiles", {library_id: lib,
        source_location_id: loc, sources_file_path_ids: ids,
        target_location_id: loc,
        target_location_relative_directory_path: rel});
      toast(`moving ${ids.length} into ${r.name}/`);
      clearSel();
      setTimeout(browse, 500);
    };
  }
}

function listRow(r) {
  // div-based (not <tr>) so the virtual renderer can absolutely
  // position each row inside the windowed scroller.
  const tr = document.createElement("div");
  tr.className = "lrow" + (selection.has(r.id) ? " sel" : "");
  const kindName = r.is_dir ? "folder" : (r.extension || "file");
  const size = r.is_dir ? "" : fmtBytes(r.size_in_bytes || 0);
  const dm = r.date_modified
    ? new Date(r.date_modified * 1000).toISOString().slice(0, 16)
        .replace("T", " ") : "";
  tr.dataset.fpid = r.id;
  tr.innerHTML = `<span>${r.is_dir ? "📁" : "🗎"}</span>` +
    `<span>${esc(r.name)}${r.extension ? "." + esc(r.extension) : ""}` +
    `</span><span>${esc(kindName)}</span><span>${size}</span>` +
    `<span>${dm}</span>`;
  tr.onclick = (e) => entryClick(r, e);
  tr.ondblclick = () => openEntry(r);
  tr.oncontextmenu = (e) => showCtx(r, e);
  wireDnD(tr, r);
  return tr;
}
function cell(r, onclick) {
  const c = document.createElement("div"); c.className = "cell";
  if (!onclick) c.dataset.fpid = r.id;
  if (selection.has(r.id) || (selected && selected.id === r.id))
    c.className += " sel";
  const t = document.createElement("div"); t.className = "thumb";
  if (r.cas_id) {
    const img = document.createElement("img");
    img.src = `/spacedrive/thumbnail/${r.cas_id}.webp`;
    img.onerror = () => { img.remove(); t.textContent = "🗎"; };
    t.appendChild(img);
  } else t.textContent = r.is_dir ? "📁" : "🗎";
  const n = document.createElement("div"); n.className = "nm";
  n.textContent = r.name + (r.extension ? "." + r.extension : "");
  c.appendChild(t); c.appendChild(n);
  if (onclick) c.onclick = onclick;       // the ".." up-cell
  else {
    c.onclick = (e) => entryClick(r, e);
    c.ondblclick = () => openEntry(r);
    c.oncontextmenu = (e) => showCtx(r, e);
    wireDnD(c, r);
  }
  return c;
}

// ---- Per-location settings (indexer-rule editor, rescans) ------------
const RULE_KINDS = [[0, "accept glob"], [1, "reject glob"],
  [2, "accept if children"], [3, "reject if children"]];
async function renderLocSettings() {
  const main = document.getElementById("main");
  if (!lib || settingsLoc == null) {
    main.innerHTML = "<div class='muted'>no location selected</div>"; return;
  }
  const [l, allRules, attachedRules, online] = await Promise.all([
    q("locations.get", {library_id: lib, location_id: settingsLoc}),
    q("locations.indexer_rules.list", {library_id: lib}),
    q("locations.indexer_rules.listForLocation",
      {library_id: lib, location_id: settingsLoc}),
    q("locations.online", {library_id: lib}),
  ]);
  if (!l) { main.innerHTML = "<div class='muted'>gone</div>"; return; }
  const isOnline = online.includes(l.id);
  const attached = new Set((attachedRules || []).map(r => r.id));
  main.innerHTML = `
    <h1>Location settings — ${esc(l.name || l.path)}</h1>
    <div class="kv">path: <b>${esc(l.path)}</b>
      ${isOnline ? "🟢 online" : "⚫ offline"}
      ${isOnline ? "" :
        '<button id="lsrelink" class="ghost">relink…</button>'}</div>
    <div class="kv">id: <b>${l.id}</b> · hidden: <b>${l.hidden ? "yes"
      : "no"}</b> · indexed <b>${esc(String(l.date_created || "?"))}
      </b></div>
    <div class="kv"><button id="lsaddlib" class="ghost">
      add to another library…</button></div>
    <p>
      <input id="lsname" value="${esc(l.name || "")}"
             placeholder="display name"/>
      <button id="lsrename">rename</button>
      <button id="lshide" class="ghost">${l.hidden ? "unhide" : "hide"}
      </button>
    </p>
    <p>
      <button id="lsfull">full rescan</button>
      <button id="lsquick" class="ghost">quick rescan</button>
      <button id="lsmkdir" class="ghost">create subdirectory…</button>
      <button id="lsdelete" class="danger">remove location</button>
    </p>
    <h2>Indexer rules</h2>
    <div class="muted">checked rules apply when this location is
      indexed</div>
    <div id="lsrules"></div>
    <h3>New rule</h3>
    <p>
      <input id="nrname" placeholder="rule name" style="width:130px"/>
      <select id="nrkind">${RULE_KINDS.map(([v, t]) =>
        `<option value="${v}">${t}</option>`).join("")}</select>
      <input id="nrglob" placeholder="glob, e.g. **/*.tmp"
             style="width:160px"/>
      <button id="nradd">add rule</button>
    </p>`;
  document.getElementById("lsmkdir").onclick = async () => {
    const sp = prompt("subdirectory path (relative to the location)");
    if (!sp) return;
    try {
      await mut("locations.createDirectory",
                {library_id: lib, location_id: l.id, sub_path: sp});
      toast("created");
    } catch (e) { toast(e.message); }
  };
  const relinkBtn = document.getElementById("lsrelink");
  if (relinkBtn) relinkBtn.onclick = async () => {
    const path = prompt("new absolute path for this location");
    if (!path) return;
    await mut("locations.relink",
              {library_id: lib, location_id: l.id, path});
    toast("relinked"); renderLocSettings();
  };
  document.getElementById("lsaddlib").onclick = async () => {
    const target = prompt("target library id (uuid)");
    if (!target) return;
    try {
      await mut("locations.addLibrary",
                {library_id: target, path: l.path});
      toast("added to library");
    } catch (e) { toast(e.message); }
  };
  const rulesEl = document.getElementById("lsrules");
  for (const r of allRules) {
    const d = document.createElement("div"); d.className = "kv";
    const cb = document.createElement("input");
    cb.type = "checkbox"; cb.checked = attached.has(r.id);
    cb.onchange = async () => {
      const ids = new Set(attached);
      cb.checked ? ids.add(r.id) : ids.delete(r.id);
      await mut("locations.update", {library_id: lib, id: l.id,
        indexer_rules_ids: [...ids]});
      renderLocSettings();
    };
    d.appendChild(cb);
    const nm = document.createElement("span");
    nm.textContent = ` ${r.name} `;
    nm.style.cursor = "pointer";
    nm.title = "click for rule details";
    nm.onclick = async () => {
      const full = await q("locations.indexer_rules.get",
                           {library_id: lib, id: r.id});
      toast(`${full.name}: ${full.rules_per_kind ? "rules blob "
        + full.rules_per_kind.length + " B" : "no params"}`);
    };
    d.appendChild(nm);
    if (r.default_rule) {
      const s = document.createElement("span");
      s.className = "muted"; s.textContent = "(system)";
      d.appendChild(s);
    } else {
      const del = document.createElement("button");
      del.className = "danger"; del.textContent = "×";
      del.onclick = async () => {
        await mut("locations.indexer_rules.delete",
                  {library_id: lib, id: r.id});
        renderLocSettings();
      };
      d.appendChild(del);
    }
    rulesEl.appendChild(d);
  }
  document.getElementById("lsrename").onclick = async () => {
    await mut("locations.update", {library_id: lib, id: l.id,
      name: document.getElementById("lsname").value});
    loadLocs(); renderLocSettings();
  };
  document.getElementById("lshide").onclick = async () => {
    await mut("locations.update", {library_id: lib, id: l.id,
      hidden: l.hidden ? 0 : 1});
    renderLocSettings();
  };
  document.getElementById("lsfull").onclick = async () => {
    await mut("locations.fullRescan",
              {library_id: lib, location_id: l.id});
    toast("full rescan started");
  };
  document.getElementById("lsquick").onclick = async () => {
    await mut("locations.quickRescan",
              {library_id: lib, location_id: l.id, sub_path: "/"});
    toast("quick rescan started");
  };
  document.getElementById("lsdelete").onclick = async () => {
    if (!confirm("remove this location from the library?")) return;
    await mut("locations.delete", {library_id: lib, id: l.id});
    if (loc === l.id) loc = null;
    settingsLoc = null; view = "explorer"; renderTabs();
    loadLocs(); render();
  };
  document.getElementById("nradd").onclick = async () => {
    const name = document.getElementById("nrname").value.trim();
    const glob = document.getElementById("nrglob").value.trim();
    const kind = parseInt(document.getElementById("nrkind").value);
    if (!name || !glob) { toast("name + glob required"); return; }
    await mut("locations.indexer_rules.create", {library_id: lib,
      name, rules: [[kind, [glob]]]});
    renderLocSettings();
  };
}

// ---- Inspector (file detail panel) -----------------------------------
async function inspect(r) {
  selected = r;
  const el = document.getElementById("inspector");
  el.style.display = "block";
  const name = r.name + (r.extension ? "." + r.extension : "");
  const size = r.size_in_bytes_bytes ? parseInt(r.size_in_bytes_bytes, 16) ||
               r.size_in_bytes : r.size_in_bytes;
  let html = `<h3>${esc(name)}</h3>` +
    `<div class="kv">size: <b>${fmtBytes(size)}</b></div>` +
    `<div class="kv">cas_id: <b>${esc(r.cas_id || "—")}</b></div>` +
    `<div class="kv">object: <b>${r.object_id ?? "—"}</b></div>` +
    `<div class="kv">path: <b>${esc(r.materialized_path)}</b></div>`;
  let obj = null;
  if (r.object_id != null) {
    obj = await q("files.get", {library_id: lib, id: r.object_id});
    if (obj) {
      html += `<div class="kv">kind: <b>${obj.kind}</b></div>` +
        `<div class="kv">note: <b>${esc(obj.note || "—")}</b></div>`;
    }
  }
  html += `<div id="itags"></div><div id="ilabels"></div>
    <div id="iexif"></div>
    <div style="margin-top:8px">
      <button id="ifav" class="ghost">${obj && obj.favorite ? "★" : "☆"} favorite</button>
      <button id="irename" class="ghost">rename</button>
      <button id="inote" class="ghost">note</button>
      <button id="idup" class="ghost">duplicate</button>
      <button id="idel" class="danger">delete</button>
    </div>`;
  el.innerHTML = html;
  if (r.object_id != null) {
    const renderChips = (el, title, items, mineIds, onToggle, onCtx) => {
      el.innerHTML = `<h3>${title}</h3>`;
      for (const it of items) {
        const chip = document.createElement("span");
        chip.className = "tagchip" + (mineIds.has(it.id) ? " on" : "");
        chip.textContent = it.name;
        chip.onclick = () => onToggle(it, mineIds.has(it.id));
        if (onCtx) chip.oncontextmenu = (ev) => {
          ev.preventDefault(); onCtx(it);
        };
        el.appendChild(chip);
      }
      return el;
    };
    const mine = await q("tags.getForObject",
      {library_id: lib, object_id: r.object_id});
    renderChips(document.getElementById("itags"), "tags", allTags,
      new Set(mine.map(t => t.id)), async (t, has) => {
        await mut("tags.assign", {library_id: lib, tag_id: t.id,
          object_id: r.object_id, unassign: has});
        inspect(r);
      });
    // labels (net-new surface over the schema's Label model)
    const [allLabels, mineL] = await Promise.all([
      q("labels.list", {library_id: lib}),
      q("labels.getForObject", {library_id: lib,
                                object_id: r.object_id}),
    ]);
    const ll = renderChips(document.getElementById("ilabels"), "labels",
      allLabels, new Set(mineL.map(x => x.id)), async (lbl, has) => {
        await mut("labels.assign", {library_id: lib, label_id: lbl.id,
          object_id: r.object_id, unassign: has});
        inspect(r);
      }, async (lbl) => {
        if (confirm(`delete label "${lbl.name}" everywhere?`)) {
          await mut("labels.delete", {library_id: lib, id: lbl.id});
          inspect(r);
        }
      });
    const addl = document.createElement("span");
    addl.className = "tagchip"; addl.textContent = "+ label";
    addl.onclick = async () => {
      const nm = prompt("label name"); if (!nm) return;
      const lbl = await mut("labels.create", {library_id: lib, name: nm});
      await mut("labels.assign", {library_id: lib, label_id: lbl.id,
        object_id: r.object_id});
      inspect(r);
    };
    ll.appendChild(addl);
    const md = await q("files.getMediaData", {library_id: lib,
                                              id: r.object_id});
    if (md) {
      if (md.stream_data) {
        // audio/video container metadata rides as JSON
        try { Object.assign(md, JSON.parse(md.stream_data)); } catch {}
        delete md.stream_data;
      }
      const ex = document.getElementById("iexif");
      ex.innerHTML = "<h3>media data</h3>" +
        Object.entries(md).filter(([k, v]) => v != null && k !== "phash" &&
                                  k !== "object_id" && k !== "id")
          .map(([k, v]) => `<div class="kv">${esc(k)}: <b>${esc(v)}</b></div>`)
          .join("");
    }
  }
  document.getElementById("ifav").onclick = async () => {
    if (r.object_id == null) return toast("not identified yet");
    await mut("files.setFavorite", {library_id: lib, id: r.object_id,
      favorite: !(obj && obj.favorite)});
    inspect(r);
  };
  document.getElementById("irename").onclick = async () => {
    const nn = prompt("new name", name); if (!nn || nn === name) return;
    try {
      await mut("files.renameFile", {library_id: lib, file_path_id: r.id,
        new_name: nn});
      toast("renamed"); browse();
    } catch (e) { toast(e.message); }
  };
  document.getElementById("inote").onclick = async () => {
    if (r.object_id == null) return toast("not identified yet");
    const note = prompt("note", obj && obj.note || "");
    if (note === null) return;
    await mut("files.setNote", {library_id: lib, id: r.object_id, note});
    inspect(r);
  };
  document.getElementById("idup").onclick = async () => {
    await mut("files.duplicateFiles", {library_id: lib, location_id: loc,
      file_path_ids: [r.id]});
    toast("duplicating…");
  };
  document.getElementById("idel").onclick = async () => {
    if (!confirm(`delete ${name}?`)) return;
    await mut("files.deleteFiles", {library_id: lib, location_id: loc,
      file_path_ids: [r.id]});
    el.style.display = "none"; selected = null;
  };
}

// ---- Duplicates ------------------------------------------------------
async function renderDups() {
  const main = document.getElementById("main");
  if (!lib) return;
  const groups = await q("search.duplicates",
    {library_id: lib, location_id: loc});
  const total = groups.reduce((a, g) => a + (g.reclaimable_bytes || 0), 0);
  main.innerHTML = `<h3>Exact duplicates (by CAS ID)</h3>
    <div class="muted">${groups.length} groups · ` +
    `${fmtBytes(total)} reclaimable</div>
    <table><tr><th>cas_id</th><th>copies</th><th>total</th>
    <th>paths</th></tr>` +
    groups.map(g => `<tr><td>${esc(g.cas_id)}</td><td>${g.count}</td>
      <td>${fmtBytes(g.total_bytes)}</td>
      <td class="muted">${g.paths.map(esc).join("<br>")}</td></tr>`).join("")
    + "</table>";
}

// ---- Near-duplicates (device-backed analytics) -----------------------
async function renderNearDups() {
  const main = document.getElementById("main");
  if (!lib) return;
  const pairs = await q("search.nearDuplicates",
    {library_id: lib, max_distance: 10});
  main.innerHTML = `<h3>Near-duplicate images (pHash Hamming ≤ 10)</h3>
    <div style="margin:6px 0">
      <button id="rundet">run detector on location ${loc ?? "—"}</button>
      <span class="muted">batched DCT pHash + tiled Hamming all-pairs on
      the device; LSH bucketing past 100k images</span></div>
    <table><tr><th>distance</th><th>a</th><th>b</th></tr>` +
    pairs.map(p => `<tr><td>${p.distance}</td>
      <td class="muted">${p.paths_a.map(esc).join("<br>")}</td>
      <td class="muted">${p.paths_b.map(esc).join("<br>")}</td></tr>`)
      .join("") + "</table>";
  document.getElementById("rundet").onclick = async () => {
    if (loc == null) return toast("select a location first");
    await mut("jobs.nearDupDetector", {library_id: lib, id: loc});
    toast("near-dup detector started");
  };
}

// ---- Jobs console ----------------------------------------------------
const JSTATUS = {0:"queued",1:"running",2:"completed",3:"cancelled",
                 4:"failed",5:"paused",6:"completed+errors"};
async function renderJobs() {
  const main = document.getElementById("main");
  if (!lib) return;
  const reports = await q("jobs.reports", {library_id: lib});
  main.innerHTML = `<h3>Jobs</h3>
    <div style="margin:6px 0">
      <button id="jid">identify</button>
      <button id="jval">validate</button>
      <button id="jverify" class="ghost">verify (bit-rot)</button>
      <button id="jthumb" class="ghost">thumbnails</button>
      <button id="jclear" class="ghost">clear finished</button>
    </div>
    <table><tr><th>name</th><th>status</th><th>progress</th><th>created</th>
    <th></th></tr>` +
    reports.map(j => {
      const pct = j.task_count ?
        Math.round(100 * (j.completed_task_count || 0) / j.task_count) : 0;
      const running = j.status === 1, paused = j.status === 5;
      return `<tr><td>${esc(j.name)}</td><td>${JSTATUS[j.status] ?? j.status}</td>
        <td>${pct}% (${j.completed_task_count || 0}/${j.task_count || 0})</td>
        <td class="muted">${new Date((j.date_created||0)*1000)
          .toLocaleTimeString()}</td>
        <td>${running ? `<button class="ghost" onclick="jobCtl('pause','${j.id}')">⏸</button>` : ""}
            ${paused ? `<button class="ghost" onclick="jobCtl('resume','${j.id}')">▶</button>` : ""}
            ${(running || paused) ? `<button class="danger" onclick="jobCtl('cancel','${j.id}')">✕</button>` : ""}
        </td></tr>`;
    }).join("") + "</table>";
  const need = () => loc == null ? (toast("select a location"), false) : true;
  document.getElementById("jid").onclick = async () =>
    need() && (await mut("jobs.identifyUniqueFiles", {library_id: lib, id: loc}),
               renderJobs());
  document.getElementById("jval").onclick = async () =>
    need() && (await mut("jobs.objectValidator", {library_id: lib, id: loc}),
               renderJobs());
  document.getElementById("jverify").onclick = async () =>
    need() && (await mut("jobs.objectValidator",
                         {library_id: lib, id: loc, mode: "verify"}),
               renderJobs());
  document.getElementById("jthumb").onclick = async () =>
    need() && (await mut("jobs.generateThumbsForLocation",
                         {library_id: lib, id: loc}), renderJobs());
  document.getElementById("jclear").onclick = async () => {
    await mut("jobs.clearAll", {library_id: lib}); renderJobs();
  };
}
window.jobCtl = async (op, id) => {
  await mut("jobs." + op, {library_id: lib, id});
  renderJobs();
};

// ---- P2P -------------------------------------------------------------
async function renderP2P() {
  const main = document.getElementById("main");
  const st = await q("p2p.state");
  if (!st.enabled) {
    main.innerHTML = "<div class='muted'>p2p is not started</div>"; return;
  }
  main.innerHTML = `<h3>P2P</h3>
    <div class="kv">identity: <b>${esc(st.identity.slice(0, 24))}…</b>
      · port <b>${st.port}</b></div>
    <h3>Peers</h3>
    <table><tr><th>identity</th><th>addr</th><th></th></tr>` +
    st.peers.map(p => {
      // Beacon payloads are peer-controlled: port must never reach
      // innerHTML/onclick as a string (stored-XSS vector).
      const port = Number(p.port) || 0;
      return `<tr>
      <td class="muted">${esc(p.identity.slice(0, 24))}…</td>
      <td>${esc(p.addr)}:${port}</td>
      <td><button class="ghost" onclick="p2pPing('${esc(p.addr)}',${port})">ping</button>
          <button class="ghost" onclick="p2pPair('${esc(p.addr)}',${port})">pair</button>
          <button onclick="p2pDrop('${esc(p.addr)}',${port})">spacedrop</button>
      </td></tr>`;}).join("") + `</table>
    <div class="muted" style="margin-top:8px">spacedrop sends an absolute
    file path from this node; pairing joins the current library.</div>`;
}
window.p2pPing = async (addr, port) => {
  try { await mut("p2p.debugPing", {addr, port}); toast("pong"); }
  catch (e) { toast(e.message); }
};
window.p2pPair = async (addr, port) => {
  try {
    await mut("p2p.pair", {library_id: lib, addr, port});
    toast("paired");
  } catch (e) { toast(e.message); }
};
window.p2pDrop = async (addr, port) => {
  const file_path = prompt("absolute path of file to send");
  if (!file_path) return;
  try {
    await mut("p2p.spacedrop", {addr, port, file_path});
    toast("spacedrop sent");
  } catch (e) { toast(e.message); }
};

// ---- Settings --------------------------------------------------------
async function renderSettings() {
  const main = document.getElementById("main");
  if (!lib) return;
  const [stats, cats, vols, keysSetup, backups, prefs, nstate, info,
         notifs, syncOps] = await Promise.all([
    q("library.statistics", {library_id: lib}),
    q("categories.list", {library_id: lib}),
    q("volumes.list"),
    q("keys.isSetup", {library_id: lib}),
    q("backups.getAll"),
    q("preferences.get", {library_id: lib}),
    q("nodeState"),
    q("buildInfo"),
    q("notifications.get"),
    q("sync.messages", {library_id: lib}),
  ]);
  let account;
  try { account = await q("auth.me"); } catch (e) { account = null; }
  const catRows = Object.entries(cats).filter(([, n]) => n > 0)
    .map(([k, n]) => `<tr><td>${esc(k)}</td><td>${n}</td></tr>`).join("");
  main.innerHTML = `<h3>Account</h3><div id="account">` + (account
    ? `<div class="kv">signed in: <b>${esc(account.email)}</b>
       (${esc(account.id)})</div>
       <button id="logoutbtn" class="ghost">log out</button>`
    : `<button id="loginbtn">log in (device flow)</button>
       <span id="logincode" class="muted"></span>`) + `</div>
    <h3>This node</h3>
    <div class="kv">name: <b>${esc(nstate.name)}</b>
      <button id="renamenode" class="ghost">rename</button>
      · v${esc(info.version)}</div>
    <div class="kv">features: <b>${esc(nstate.features.join(", ") ||
      "none")}</b>
      <button id="togglep2pfiles" class="ghost">toggle filesOverP2P
      </button></div>
    <h3>Library</h3>
    <div class="kv"><button id="renamelib" class="ghost">rename library
      </button></div>
    <h3>Statistics</h3>` +
    Object.entries(stats).map(([k, v]) =>
      `<div class="kv">${esc(k)}: <b>${esc(v)}</b></div>`).join("") +
    `<h3>Categories</h3><table>${catRows}</table>
    <h3>Sync</h3>
    <div class="kv">op log: <b>${syncOps.length}</b> ops (latest page)
      <span id="synclive" class="muted"></span></div>
    <h3>Notifications</h3>
    <button id="notifytest" class="ghost">test (node)</button>
    <button id="notifytestlib" class="ghost">test (library)</button>
    <button id="dismissall" class="ghost">dismiss all</button>
    <table>` + notifs.slice(0, 8).map(nn =>
      `<tr><td>${esc(nn.kind || nn.title || "notification")}</td>
       <td class="muted">${nn.read ? "read" : "unread"}</td>
       <td><button class="ghost ndismiss" data-nid="${nn.id}"
            data-nlib="${esc(nn.library_id || lib)}">dismiss
       </button></td></tr>`).join("") + `</table>
    <h3>Volumes</h3><table>` +
    vols.map(v => `<tr><td>${esc(v.name || v.mount_point)}</td>
      <td>${fmtBytes(v.available_capacity)} free of
          ${fmtBytes(v.total_capacity)}</td></tr>`).join("") + `</table>
    <h3>Key manager</h3><div id="keys"></div>
    <h3>Backups</h3>
    <div><button id="dobackup">backup library now</button></div>
    <table>` + (backups.backups || backups).map(b =>
      `<tr><td>${esc(b.id || b.path || JSON.stringify(b)).slice(0, 60)}</td>
       <td class="muted">${esc(b.timestamp || b.date || "")}</td>
       <td><button class="ghost brestore" data-bid="${esc(b.id)}">restore
       </button><button class="danger bdelete" data-bid="${esc(b.id)}">×
       </button></td></tr>`)
      .join("") + `</table>
    <h3>Preferences</h3>
    <div class="kv">stored keys: <b>${Object.keys(prefs || {}).length}</b>
      <button id="setpref" class="ghost">set pref</button></div>`;

  // account card wiring (the RFC 8628 device flow, api/auth.rs)
  const loginBtn = document.getElementById("loginbtn");
  if (loginBtn) loginBtn.onclick = () => {
    subOnce("auth.loginSession", {poll_interval: 0.3}, (ev) => {
      const codeEl = document.getElementById("logincode");
      if (ev.state === "Start") {
        if (codeEl) codeEl.textContent =
          ` enter code ${ev.user_code} at ${ev.verification_url}`;
        return false;              // keep listening
      }
      if (ev.state === "Complete") { toast("signed in"); renderSettings(); }
      else toast("login failed");
      return true;                 // terminal: stop the stream
    });
  };
  const logoutBtn = document.getElementById("logoutbtn");
  if (logoutBtn) logoutBtn.onclick = async () => {
    await mut("auth.logout"); renderSettings();
  };
  document.getElementById("renamenode").onclick = async () => {
    const name = prompt("node name"); if (!name) return;
    await mut("nodes.edit", {name}); renderSettings();
  };
  document.getElementById("togglep2pfiles").onclick = async () => {
    await mut("toggleFeatureFlag", {feature: "filesOverP2P"});
    renderSettings();
  };
  document.getElementById("renamelib").onclick = async () => {
    const name = prompt("library name"); if (!name) return;
    await mut("library.edit", {id: lib, name}); loadLibs();
  };
  document.getElementById("notifytestlib").onclick = () =>
    mut("notifications.testLibrary", {library_id: lib})
      .then(renderSettings);
  document.getElementById("dismissall").onclick = () =>
    mut("notifications.dismissAll").then(renderSettings);
  document.querySelectorAll(".ndismiss").forEach(b => b.onclick = () =>
    mut("notifications.dismiss",
        {library_id: b.dataset.nlib, id: +b.dataset.nid})
      .then(renderSettings));
  if (syncSubLib !== lib) {
    syncSubLib = lib;
    sub("sync.newMessage", {library_id: lib}, () => {
      const el = document.getElementById("synclive");
      if (el) el.textContent = " · live ops arriving";
    });
  }

  const keysEl = document.getElementById("keys");
  if (!keysSetup) {
    keysEl.innerHTML = `<button id="ksetup">set up key manager</button>`;
    document.getElementById("ksetup").onclick = async () => {
      const pw = prompt("master password"); if (!pw) return;
      await mut("keys.setup", {library_id: lib, password: pw});
      renderSettings();
    };
  } else {
    const unlocked = await q("keys.isUnlocked", {library_id: lib});
    if (!unlocked) {
      keysEl.innerHTML = `<button id="kunlock">unlock</button>`;
      document.getElementById("kunlock").onclick = async () => {
        const pw = prompt("master password"); if (!pw) return;
        try {
          await mut("keys.unlock", {library_id: lib, password: pw});
          renderSettings();
        } catch (e) { toast(e.message); }
      };
    } else {
      const keys = await q("keys.list", {library_id: lib});
      keysEl.innerHTML = keys.map(k => {
        const u = esc(k.uuid || k.id);
        return `<div class="kv">${u} ${k.mounted ? "(mounted)" : ""}
          <button class="ghost kmnt" data-ku="${u}"
            data-m="${k.mounted ? 1 : 0}">
            ${k.mounted ? "unmount" : "mount"}</button>
          <button class="danger kdel" data-ku="${u}">×</button>
        </div>`;
      }).join("") +
        `<button id="kadd" class="ghost">add key</button>
         <button id="klock" class="ghost">lock</button>`;
      keysEl.querySelectorAll(".kmnt").forEach(b => b.onclick =
        async () => {
          await mut(+b.dataset.m ? "keys.unmount" : "keys.mount",
                    {uuid: b.dataset.ku});
          renderSettings();
        });
      keysEl.querySelectorAll(".kdel").forEach(b => b.onclick =
        async () => {
          if (!confirm("delete this key?")) return;
          await mut("keys.delete", {uuid: b.dataset.ku});
          renderSettings();
        });
      document.getElementById("kadd").onclick = async () => {
        const pw = prompt("new key password"); if (!pw) return;
        await mut("keys.add", {key: pw});
        renderSettings();
      };
      document.getElementById("klock").onclick = async () => {
        await mut("keys.lock", {library_id: lib}); renderSettings();
      };
    }
  }
  document.getElementById("dobackup").onclick = async () => {
    await mut("backups.backup", {library_id: lib});
    toast("backup written"); renderSettings();
  };
  document.querySelectorAll(".brestore").forEach(b => b.onclick =
    async () => {
      if (!confirm("restore this backup over the current library?"))
        return;
      await mut("backups.restore", {backup_id: b.dataset.bid});
      toast("backup restored"); loadAll();
    });
  document.querySelectorAll(".bdelete").forEach(b => b.onclick =
    async () => {
      await mut("backups.delete", {backup_id: b.dataset.bid});
      renderSettings();
    });
  document.getElementById("setpref").onclick = async () => {
    const k = prompt("preference key"); if (!k) return;
    const v = prompt("value");
    await mut("preferences.update", {library_id: lib, values: {[k]: v}});
    renderSettings();
  };
  document.getElementById("notifytest").onclick = () =>
    mut("notifications.test");
}

// ---- chrome wiring ---------------------------------------------------
document.getElementById("newlib").onclick = async () => {
  const name = prompt("library name"); if (!name) return;
  await mut("library.create", {name}); lib = null; loadLibs();
};
document.getElementById("newloc").onclick = async () => {
  const path = prompt("absolute path to index"); if (!path || !lib) return;
  await mut("locations.create", {library_id: lib, path});
  loadLocs();
};
document.getElementById("newtag").onclick = async () => {
  const name = prompt("tag name"); if (!name || !lib) return;
  const color = prompt("color (css, optional)") || null;
  await mut("tags.create", {library_id: lib, name, color});
  loadTags();
};
document.getElementById("newalbum").onclick = async () => {
  const name = prompt("album name"); if (!name || !lib) return;
  await mut("albums.create", {library_id: lib, name});
  loadGroupings();
};
document.getElementById("newspace").onclick = async () => {
  const name = prompt("space name"); if (!name || !lib) return;
  const description = prompt("description (optional)") || null;
  await mut("spaces.create", {library_id: lib, name, description});
  loadGroupings();
};
document.getElementById("search").oninput = (() => {
  let h; return () => { clearTimeout(h); h = setTimeout(() => {
    if (view !== "explorer") { view = "explorer"; renderTabs(); }
    browse();
  }, 250); };
})();
document.getElementById("favbtn").onclick = () => {
  favOnly = !favOnly;
  document.getElementById("favbtn").className = favOnly ? "" : "ghost";
  if (view === "explorer") browse();
};
function setViewMode(m) {
  viewMode = m;
  for (const [id, mm] of [["vgrid","grid"],["vlist","list"],
                          ["vmedia","media"]])
    document.getElementById(id).className =
      "viewbtn" + (viewMode === mm ? " on" : "");
  if (view === "explorer") browse();
}
document.getElementById("vgrid").onclick = () => setViewMode("grid");
document.getElementById("vlist").onclick = () => setViewMode("list");
document.getElementById("vmedia").onclick = () => setViewMode("media");
document.getElementById("pastebtn").onclick = doPaste;
document.getElementById("newfolder").onclick = async () => {
  if (view !== "explorer") { toast("open the explorer first"); return; }
  if (loc == null) { toast("select a location"); return; }
  const name = prompt("folder name"); if (!name) return;
  await mut("files.createFolder", {library_id: lib, location_id: loc,
    sub_path: curPath, name});
  setTimeout(() => { if (view === "explorer") browse(); }, 300);
};
setViewMode("grid");

sub("jobs.progress", null, (e) => {
  const el = document.getElementById("joblist");
  let row = document.getElementById("job-" + e.id);
  if (!row) {
    row = document.createElement("div"); row.className = "job";
    row.id = "job-" + e.id;
    row.innerHTML = `<span></span><div class="bar"><div></div></div>`;
    el.prepend(row);
  }
  row.querySelector("span").textContent =
    `${e.name || "job"} — ${e.message || ""}`;
  const pct = e.task_count ? (100 * (e.completed_task_count || 0) /
                              e.task_count) : 0;
  row.querySelector(".bar > div").style.width = pct + "%";
  if (e.task_count && e.completed_task_count >= e.task_count)
    setTimeout(() => row.remove(), 4000);
});
sub("invalidation.listen", null, (e) => {
  if (e.key === "search.paths" && view === "explorer") browse();
  if (e.key === "library.list") loadLibs();
  if (e.key === "tags.list") loadTags();
  if (e.key === "albums.list" || e.key === "spaces.list")
    loadGroupings();
  if (e.key === "jobs.reports" && view === "jobs") renderJobs();
});
sub("notifications.listen", null, (e) => {
  toast(`🔔 ${e.title || ""} ${e.content || e.message || ""}`);
});
sub("jobs.newThumbnail", null, (e) => {
  // live-patch just the matching cell's image — a directory of
  // hundreds of thumbnails must not trigger a refetch per event
  if (view !== "explorer" || !e.cas_id) return;
  const r = lastRows.find(x => x && x.cas_id === e.cas_id);
  if (!r) return;
  const el = document.querySelector(`[data-fpid="${r.id}"] .thumb`);
  if (!el || el.querySelector("img")) return;
  el.textContent = "";
  const img = document.createElement("img");
  img.src = `/spacedrive/thumbnail/${e.cas_id}.webp`;
  img.onerror = () => { img.remove(); el.textContent = "🗎"; };
  el.appendChild(img);
});
sub("p2p.events", null, async (e) => {
  if (e.type === "SpacedropProgress") {
    const el = document.getElementById("joblist");
    let row = document.getElementById("drop-" + e.id);
    if (!row) {
      row = document.createElement("div"); row.className = "job";
      row.id = "drop-" + e.id;
      row.innerHTML = `<span></span>
        <button class="ghost" style="float:right;font-size:10px">cancel
        </button><div class="bar"><div></div></div>`;
      row.querySelector("button").onclick = () =>
        mut("p2p.cancelSpacedrop", {id: e.id}).then(() => row.remove());
      el.prepend(row);
    }
    const pct = e.total ? Math.round(100 * e.bytes / e.total) : 0;
    row.querySelector("span").textContent =
      `spacedrop ${e.direction || ""} ${pct}%`;
    row.querySelector(".bar > div").style.width = pct + "%";
    if (e.bytes >= e.total) setTimeout(() => row.remove(), 3000);
    return;
  }
  if (e.type === "SpacedropRequest") {
    // The peer-supplied name is untrusted: suggest only its basename,
    // never a path ("../../etc/x" must not prefill the save prompt).
    const safe = (e.name || "spacedrop.bin")
      .split(/[\\/]/).pop().replace(/^\.+/, "") || "spacedrop.bin";
    const ok = confirm(
      `Spacedrop: accept "${safe}" (${e.size} bytes) from ${e.peer}?`);
    // Cancelling/clearing the prompt falls back to the safe name in the
    // current directory — an accepted drop is never silently rejected.
    const path = ok ? (prompt("save as", safe) || safe) : null;
    await mut("p2p.acceptSpacedrop", {id: e.id, path});
  }
});
renderTabs();
loadLibs();
