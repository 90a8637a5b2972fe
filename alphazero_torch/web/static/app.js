/* Breakthrough web UI: board rendering, click-to-move with legal-move
 * highlighting, human/AlphaZero/baseline selectors per color, bot-vs-bot
 * game loop with stop flag, move history, evaluation bar. */

const COLS = "abcdefgh";

const state = {
  board: null,          // [8][8] ints, row 0 = white home (rendered bottom)
  turn: "white",
  legalMoves: [],
  selected: null,       // [r, c]
  gameOver: false,
  whiteType: "human",
  blackType: "alphazero",
  botLoop: false,
  busy: false,
};

const $ = (id) => document.getElementById(id);

async function api(path, body) {
  const opts = body !== undefined
    ? { method: "POST", headers: { "Content-Type": "application/json" },
        body: JSON.stringify(body) }
    : {};
  const res = await fetch(path, opts);
  const data = await res.json();
  if (!res.ok) throw new Error(data.error || res.statusText);
  return data;
}

function moveName(m) {
  const [fr, fc, tr, tc] = m;
  return `${COLS[fc]}${fr + 1}→${COLS[tc]}${tr + 1}`;
}

function applyState(data) {
  if (data.board) state.board = data.board;
  if (data.turn) state.turn = data.turn;
  state.legalMoves = data.legal_moves || [];
  state.gameOver = !!data.game_over;
  if (data.bot_move) addMove(data.bot_move, true);
  if (data.evaluation !== undefined) setEval(data.evaluation);
  if (data.engine) {
    // baseline engine search stats (depth/nodes/nps come with every
    // baseline bot_move response; reference tracks these in
    // baseline/search.py:147-148)
    $("engineInfo").textContent =
      `engine: depth ${data.engine.depth}  nodes ` +
      `${data.engine.nodes.toLocaleString()}  ` +
      `${Math.round(data.engine.nps).toLocaleString()} nps`;
  }
  renderBoard();
  renderStatus(data.result);
}

function setEval(v) {
  // v in [-1, 1], White-positive
  const pct = 50 + 50 * Math.max(-1, Math.min(1, v));
  $("evalFill").style.height = `${pct}%`;
  $("evalText").textContent = (v >= 0 ? "+" : "") + v.toFixed(2);
}

function addMove(m, isBot) {
  const li = document.createElement("li");
  li.textContent = moveName(m) + (isBot ? " \u{1F916}" : "");
  $("moveList").appendChild(li);
  $("moveList").scrollTop = $("moveList").scrollHeight;
}

function renderStatus(result) {
  const el = $("status");
  if (state.gameOver) {
    el.textContent = result || "Game over";
    el.className = "status done";
    state.botLoop = false;
    return;
  }
  const who = state.turn === "white" ? "White" : "Black";
  const type = state.turn === "white" ? state.whiteType : state.blackType;
  el.textContent = `${who} to move (${type})`;
  el.className = "status";
}

function currentPlayerIsHuman() {
  const type = state.turn === "white" ? state.whiteType : state.blackType;
  return type === "human";
}

function renderBoard() {
  const boardEl = $("board");
  boardEl.innerHTML = "";
  if (!state.board) return;

  const targets = new Set();
  if (state.selected) {
    for (const m of state.legalMoves) {
      if (m[0] === state.selected[0] && m[1] === state.selected[1]) {
        targets.add(`${m[2]},${m[3]}`);
      }
    }
  }
  const movable = new Set(state.legalMoves.map((m) => `${m[0]},${m[1]}`));

  for (let r = 7; r >= 0; r--) {
    for (let c = 0; c < 8; c++) {
      const sq = document.createElement("div");
      sq.className = `sq ${(r + c) % 2 ? "light" : "dark"}`;
      const v = state.board[r][c];
      if (v !== 0) {
        const piece = document.createElement("div");
        piece.className = `piece ${v === 1 ? "white" : "black"}`;
        sq.appendChild(piece);
      }
      if (state.selected && state.selected[0] === r &&
          state.selected[1] === c) sq.classList.add("selected");
      if (targets.has(`${r},${c}`)) sq.classList.add("target");
      else if (!state.selected && movable.has(`${r},${c}`) &&
               currentPlayerIsHuman() && !state.gameOver)
        sq.classList.add("movable");
      sq.addEventListener("click", () => onSquareClick(r, c));
      boardEl.appendChild(sq);
    }
  }
}

async function onSquareClick(r, c) {
  if (state.gameOver || state.busy || !currentPlayerIsHuman()) return;
  if (state.selected) {
    const move = [state.selected[0], state.selected[1], r, c];
    const legal = state.legalMoves.some((m) =>
      m[0] === move[0] && m[1] === move[1] && m[2] === move[2] &&
      m[3] === move[3]);
    if (legal) {
      state.selected = null;
      addMove(move, false);
      await doMove(move);
      return;
    }
    state.selected = null;
    renderBoard();
    if (state.selected === null &&
        state.legalMoves.some((m) => m[0] === r && m[1] === c)) {
      state.selected = [r, c];
      renderBoard();
    }
    return;
  }
  if (state.legalMoves.some((m) => m[0] === r && m[1] === c)) {
    state.selected = [r, c];
    renderBoard();
  }
}

async function doMove(move) {
  state.busy = true;
  renderStatus();
  try {
    const data = await api("/api/move", { move });
    applyState(data);
  } catch (e) {
    $("status").textContent = e.message;
  } finally {
    state.busy = false;
  }
  maybeContinueBots();
}

async function botMove() {
  if (state.gameOver || state.busy) return;
  state.busy = true;
  $("status").textContent =
    `${state.turn === "white" ? "White" : "Black"} is thinking…`;
  try {
    const data = await api("/api/bot_move", {});
    applyState(data);
  } catch (e) {
    $("status").textContent = e.message;
    state.botLoop = false;
  } finally {
    state.busy = false;
  }
  maybeContinueBots();
}

function maybeContinueBots() {
  if (state.gameOver || currentPlayerIsHuman()) return;
  if (!state.botLoop) state.botLoop = true;
  setTimeout(() => { if (state.botLoop && !state.gameOver) botMove(); }, 60);
}

async function newGame() {
  state.whiteType = $("whiteType").value;
  state.blackType = $("blackType").value;
  state.selected = null;
  state.botLoop = false;
  $("moveList").innerHTML = "";
  $("engineInfo").textContent = "";
  setEval(0);
  // flip the eval bar toward the human when they play Black
  // (reference web/app.js:130-136)
  const humanIsBlack =
    state.blackType === "human" && state.whiteType !== "human";
  document.querySelector(".eval-bar").classList.toggle(
    "flipped", humanIsBlack);
  const data = await api("/api/new", {
    white_type: state.whiteType,
    black_type: state.blackType,
  });
  applyState(data);
  maybeContinueBots();
}

async function loadModels() {
  try {
    const data = await api("/api/models");
    const sel = $("modelSelect");
    sel.innerHTML = "";
    for (const m of data.models) {
      const opt = document.createElement("option");
      opt.value = m.name;
      opt.textContent = `${m.name} (${m.size_mb} MB)`;
      if (m.name === data.current) opt.selected = true;
      sel.appendChild(opt);
    }
    $("modelInfo").textContent = `current: ${data.current}`;
  } catch (e) {
    $("modelInfo").textContent = e.message;
  }
}

async function init() {
  $("newGame").addEventListener("click", newGame);
  $("stopLoop").addEventListener("click", () => { state.botLoop = false; });
  $("modelSelect").addEventListener("change", async (ev) => {
    try {
      const data = await api("/api/models/select", { model: ev.target.value });
      $("modelInfo").textContent = data.message;
    } catch (e) {
      $("modelInfo").textContent = e.message;
    }
  });
  await loadModels();
  // render an initial empty board
  try {
    const data = await api("/api/state");
    applyState(data);
  } catch (_) {
    state.board = null;
    renderBoard();
  }
}

init();
