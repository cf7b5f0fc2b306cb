#!/usr/bin/env python3
"""Time designs of the decode gather K7 on one NVIDIA card.

    python3 scripts/study_k7_variants.py [--parent DIR] [--variant NAME=PATH[:FLAGS]] ...
                                         [--rounds 2] [--time all|step0|none]

``--parent DIR``: another checkout (unpacked with ``git archive``) whose
``complexity_tokenizer_tpu_torch/csrc/decode.cu`` is the earlier two-launch
K7 (C entries ``ctok_decode_totals`` and ``ctok_decode_scatter``, a memset
node before the totals).  It is built twice: as it is, and with
extra C entries that launch each of its three graph nodes alone (the
memset, the totals kernel with its last-block scan, the scatter), so that
each can be timed as a graph of its own; for that copy the last block is
found modulo the grid, which makes the totals kernel right without the
memset.  ``--variant NAME=PATH[:FLAGS]``: a source with the C entry
``ctok_decode_gather(ids, n, row_off, B, entries, arena, V, skip_special,
scratch, out, cap, stream)`` and ``ctok_decode_info(info)``, built with the
extra ``nvcc`` flags (space-separated; a flag ``kName=V`` instead sets the
source's ``constexpr int kName`` to V); PATH ``package`` is the package's
own ``csrc/decode.cu``, which is also always the variant ``package``.  Every source is built
alone with ``nvcc`` (all at once).

Inputs, made as ``chip_smoke.py`` makes them: the corpus's ids (the Zipf
texts encoded by the native route, every seventh row framed by specials)
at the 50K and 100K vocabularies; random ids at ``[8192,128]`` and
``[16,4096]`` (1% special); ``chip_smoke.py``'s edge rows; the long-token
vocabulary (``utils/corpus.py:long_token_vocab``) on random ids; tiles
whose bytes start at every residue mod 16; all ids dropped, one id, 2,048
and 2,049 ids.  Each variant must equal the plain version bit for bit on
all of them, with both ``skip_special`` values, write no byte past the
live bytes or past a capacity it is given, and give the same result when
one CUDA graph is replayed over the same buffers with other ids.

``--ablate`` adds the package's K7 with one part taken out at a time
(``ABLATIONS``: the look-back, the staging copy, the stores, the row
offsets, the row search), timed but not checked.

Then (``--time step0`` or ``all``) the parent's nodes one at a time (Step
0 of the redesign) and (``all``), in ``--rounds`` rounds that take the
designs in turn, each design warm (CUDA-graph replay on the same buffers) and cold
(``chip_smoke._time_cold_ms``).  Prints the build report (registers,
shared bytes, blocks per SM), a line per design and shape, and one JSON
line of every time.  Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE_SRC = os.path.join(REPO, "complexity_tokenizer_tpu_torch", "csrc", "decode.cu")
P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

# parts of the package's K7 taken out one at a time (``--ablate``), to see
# what each costs; their output is wrong, so they are timed, never checked
ABLATIONS = {
    "no-look-back": [("const i64 excl = tile ? look_back(s, status, tile) : 0;",
                      "const i64 excl = (i64)tile * kTile;")],
    "no-staging": [("  if (total <= kStage) stage_bytes<false>(s, a, e, 0);\n", "")],
    "no-stores": [("    store_window(s, a, tile_base, total);\n", "")],
    "no-rows": [("  write_rows(s, a, base, tile_base, tile_base + total);\n", "")],
    "no-search": [("  find_rows(s, a, base, tile == (int)gridDim.x - 1);",
                   "  if (threadIdx.x == 0) s.rows[0] = s.rows[1] = 0;")],
    "no-ticket": [("s.tile = (int)atomicAdd(ctl, 1ull);", "s.tile = blockIdx.x;")],
    "no-fence": [("    __threadfence();  // this block's status stores come before its count\n", "")],
    # without the count the state is never reset, so the tiles go by block
    # index too, and later launches read stale status words
    "no-ticket-no-count": [("s.tile = (int)atomicAdd(ctl, 1ull);", "s.tile = blockIdx.x;"),
                           ("  if (s.last) {", "  if (false) {"),
                           ("    s.last = atomicAdd(reinterpret_cast<unsigned*>(ctl + 1), 1u) == gridDim.x - 1;",
                            "    s.last = 0;")],
}
# what is left with every part above taken out (the ids, the entries, the
# scan, the status stores), and that without the entries' gather
ABLATIONS["skeleton"] = [p for k in ("no-look-back", "no-staging", "no-stores", "no-rows",
                                     "no-search", "no-ticket-no-count") for p in ABLATIONS[k]]
ABLATIONS["skeleton-no-entries"] = ABLATIONS["skeleton"] + [
    ("(uint32_t)id[k] < (uint32_t)a.V ? __ldg(a.entries + id[k]) : make_uint4(0, 0, 0, 0);",
     "make_uint4(id[k] & 7, 0, 0, 0);")]

# appended to the parent's source: each of its three graph nodes alone
SPLIT_ENTRIES = r"""
extern "C" int study_memset(void* scratch, long long n, void* stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  return (int)cudaMemsetAsync(static_cast<i64*>(scratch) + tiles + 1, 0, sizeof(unsigned int),
                              (cudaStream_t)stream);
}
extern "C" int study_totals(const void* ids, long long n, const void* off, const void* special,
                            int V, int skip_special, void* scratch, void* stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  auto* tile_off = static_cast<i64*>(scratch);
  auto* done = reinterpret_cast<unsigned int*>(tile_off + tiles + 1);
  const Table t{static_cast<const i64*>(off), static_cast<const uint8_t*>(special), V, skip_special};
  decode_totals_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(ids), n, t, tile_off, done);
  return (int)cudaGetLastError();
}
"""


def build(sources: dict, out_dir: str) -> dict:
    """name -> (ctypes library, ptxas log); every nvcc at once."""
    sys.path.insert(0, REPO)
    from complexity_tokenizer_tpu_torch.utils.cuda_build import NVCC_FLAGS, _nvcc

    procs = {}
    for name, (text, flags) in sources.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        src = os.path.join(d, "decode.cu")
        with open(src, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *flags, "-shared", "-o", os.path.join(d, "lib.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    out = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        out[name] = (ctypes.CDLL(os.path.join(out_dir, name, "lib.so")), log)
    return out


def ptxas_lines(log: str) -> list[str]:
    keep = []
    for line in log.splitlines():
        if re.search(r"ptxas info.*(Compiling|registers)|spill|stack frame", line):
            keep.append(line.strip())
    return keep


class Design:
    """One K7 design behind one call ``fn(ids, offs, skip)`` -> buffer."""

    def __init__(self, name, lib, parent: bool, tabs, entries, max_len):
        import torch

        self.name, self.lib, self.parent = name, lib, parent
        self.arena, self.offsets, self.special = tabs
        self.entries, self.max_len = entries, max_len
        self.V = self.special.numel()
        if parent:
            lib.ctok_decode_totals.argtypes = (P, L, P, P, P, I, I, P, P)
            lib.ctok_decode_scatter.argtypes = (P, L, P, I, P, P, P, I, I, P, P, P)
        else:
            lib.ctok_decode_gather.argtypes = (P, L, P, I, P, P, I, I, P, P, L, P)
        self.scratch = torch.zeros(1 << 16, dtype=torch.int64, device="cuda")

    def _check(self, rc, what):
        if rc:
            raise RuntimeError(f"{self.name}: {what} failed with CUDA error {rc}")

    def __call__(self, ids, offs, skip, total=None, out=None, cap=None):
        """The design's buffer; the parent needs the byte total (the one
        read back between its launches, given here so that a graph can
        capture both)."""
        import torch

        n, B = ids.numel(), offs.numel() - 1
        stream = torch.cuda.current_stream().cuda_stream
        if self.parent:
            tiles = -(-n // 1024)
            self._check(self.lib.ctok_decode_totals(
                ids.data_ptr(), n, self.arena.data_ptr(), self.offsets.data_ptr(),
                self.special.data_ptr(), self.V, int(skip), self.scratch.data_ptr(), stream),
                "totals")
            if total is None:
                total = int(self.scratch[tiles])
            out = torch.empty(8 * (B + 1) + total, dtype=torch.uint8, device="cuda")
            self._check(self.lib.ctok_decode_scatter(
                ids.data_ptr(), n, offs.data_ptr(), B, self.arena.data_ptr(),
                self.offsets.data_ptr(), self.special.data_ptr(), self.V, int(skip),
                self.scratch.data_ptr(), out.data_ptr(), stream), "scatter")
            return out
        if cap is None:
            cap = n * self.max_len
        if out is None:
            out = torch.empty(8 * (B + 1) + cap, dtype=torch.uint8, device="cuda")
        self._check(self.lib.ctok_decode_gather(
            ids.data_ptr(), n, offs.data_ptr(), B, self.entries.data_ptr(), self.arena.data_ptr(),
            self.V, int(skip), self.scratch.data_ptr(), out.data_ptr(), cap, stream), "gather")
        return out


def live(buf, B: int):
    """The live part of a design's buffer: the header and the total bytes."""
    import torch

    total = int(buf[8 * B : 8 * (B + 1)].view(torch.int64)[0])
    return buf[: 8 * (B + 1) + total]


def vocab_tensors(vocab_r: dict, special_ids):
    """(tabs = (arena, offsets, special), entries, max_len) on the card."""
    import numpy as np
    import torch

    from complexity_tokenizer_tpu_torch.ops.decode import build_decode_tables, decode_entries

    t = build_decode_tables(vocab_r, special_ids)
    arena = np.zeros(-(-max(t.arena.size, 1) // 16) * 16, np.uint8)  # padded to 16 bytes
    arena[: t.arena.size] = t.arena
    tabs = tuple(torch.from_numpy(x).cuda() for x in (arena, t.offsets, t.special))
    lens = np.diff(t.offsets)
    return tabs, torch.from_numpy(decode_entries(t)).cuda(), int(lens.max()) if lens.size else 0


def check_design(d: Design, batches: list, graph_pairs: list) -> int:
    """Bit for bit against the plain version on every batch, both skip
    values; nothing written past the live bytes or past a small capacity;
    a graph replayed over the same buffers with other ids.  Returns the
    checks made."""
    import torch

    from complexity_tokenizer_tpu_torch.ops.decode import decode_gather_plain

    checks = 0
    for label, ids, offs in batches:
        B = offs.numel() - 1
        for skip in (False, True):
            exp = decode_gather_plain(ids, offs, d.entries, d.arena, skip)
            if d.parent:
                got = d(ids, offs, skip)
            else:
                cap = ids.numel() * d.max_len
                room = torch.full((8 * (B + 1) + cap + 64,), 0xAB, dtype=torch.uint8, device="cuda")
                got = d(ids, offs, skip, out=room, cap=cap)
                torch.cuda.synchronize()
                if not bool((room[exp.numel():] == 0xAB).all()):
                    raise AssertionError(f"{d.name}: bytes written past the live part on {label}")
                got = live(got, B).clone()
                # a capacity below the total: nothing past it
                small = max(0, exp.numel() - 8 * (B + 1) - 37)
                room.fill_(0xAB)
                d(ids, offs, skip, out=room, cap=small)
                torch.cuda.synchronize()
                if not bool((room[8 * (B + 1) + small:] == 0xAB).all()):
                    raise AssertionError(f"{d.name}: bytes written past the capacity on {label}")
                if not torch.equal(room[8 * (B + 1): 8 * (B + 1) + small],
                                   exp[8 * (B + 1): 8 * (B + 1) + small]):
                    raise AssertionError(f"{d.name}: clipped bytes differ on {label}")
            torch.cuda.synchronize()
            if not torch.equal(got, exp):
                bad = (got[: min(got.numel(), exp.numel())] != exp[: min(got.numel(), exp.numel())])
                first = int(torch.nonzero(bad).flatten()[0]) if bad.any() else -1
                raise AssertionError(f"{d.name} differs from the plain version on {label}, "
                                     f"skip={skip}: sizes {got.numel()} / {exp.numel()}, first "
                                     f"differing byte {first}")
            checks += 1
    if not d.parent:
        for ids_a, ids_b, offs in graph_pairs:
            B = offs.numel() - 1
            ids = ids_a.clone()
            out = torch.empty(8 * (B + 1) + ids.numel() * d.max_len, dtype=torch.uint8,
                              device="cuda")
            d(ids, offs, True, out=out)
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                d(ids, offs, True, out=out)
            for src in (ids_b, ids_a, ids_b):
                ids.copy_(src)
                g.replay()
                torch.cuda.synchronize()
                exp = decode_gather_plain(ids, offs, d.entries, d.arena, True)
                if not torch.equal(live(out, B), exp):
                    raise AssertionError(f"{d.name}: a graph replay differs from the plain version")
                checks += 1
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="a checkout whose decode.cu is the two-launch K7")
    ap.add_argument("--variant", action="append", default=[], help="NAME=PATH[:FLAGS]")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--texts", type=int, default=10_000)
    ap.add_argument("--ablate", action="store_true",
                    help="also time the package's K7 with each part of ABLATIONS taken out")
    ap.add_argument("--time", choices=("all", "step0", "none"), default="all",
                    help="none: build and check only; step0: and the parent's nodes apart")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("study_k7_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import (
        TOKENIZER_100K,
        TOKENIZER_JSON,
        _cold_sets,
        _decode_edge_rows,
        _ragged_on_card,
        _time_cold_ms,
        _time_ms,
        _with_specials,
        main_corpus,
    )
    from complexity_tokenizer_tpu_torch.tokenizer import Tokenizer
    from complexity_tokenizer_tpu_torch.utils.corpus import long_token_vocab

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    sources = {}
    with open(PACKAGE_SRC) as fh:
        text = fh.read()
    if "ctok_decode_gather" in text:  # the package's K7 has this design's C entry
        sources["package"] = (text, [])
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        path, _, flags = rest.partition(":")
        with open(PACKAGE_SRC if path == "package" else path) as fh:
            text = fh.read()
        nvcc_flags = []
        for flag in flags.split():
            if flag.startswith("-"):
                nvcc_flags.append(flag)
                continue
            const, value = flag.split("=")  # a constant of the source set otherwise
            text, n = re.subn(rf"(constexpr int {const} = )\w+;", rf"\g<1>{value};", text)
            if n != 1:
                raise RuntimeError(f"variant {name}: {const} not found once")
        sources[name] = (text, nvcc_flags)
    if args.ablate:
        for name, patches in ABLATIONS.items():
            text = sources["package"][0]
            for old, new in patches:
                if text.count(old) != 1:
                    raise RuntimeError(f"ablation {name}: its line is not in the package's K7 once")
                text = text.replace(old, new)
            sources["x-" + name] = (text, [])
    if args.parent:
        with open(os.path.join(args.parent, "complexity_tokenizer_tpu_torch", "csrc", "decode.cu")) as fh:
            text = fh.read()
        sources["parent"] = (text, [])
        split, n = re.subn(r"is_last = atomicAdd\(done, 1u\) == gridDim\.x - 1;",
                           "is_last = atomicAdd(done, 1u) % gridDim.x == gridDim.x - 1;", text)
        if n != 1:
            raise RuntimeError("the parent's last-block test was not found once")
        sources["parent-split"] = (split + SPLIT_ENTRIES, [])
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(REPO, "build")) as tmp:
        libs = build(sources, tmp)
        print(f"built {len(libs)} sources in {time.perf_counter() - t0:.1f} s", flush=True)
        for name, (lib, log) in libs.items():
            for line in ptxas_lines(log):
                print(f"[{name}] {line}")
            if hasattr(lib, "ctok_decode_info"):
                info = (ctypes.c_int * 10)()
                lib.ctok_decode_info.argtypes = (P,)
                rc = lib.ctok_decode_info(ctypes.addressof(info))
                keys = ("threads", "registers", "static_smem", "local_bytes", "blocks_per_sm")
                print(f"[{name}] rc={rc} gather {dict(zip(keys, info[:5]))} totals "
                      f"{dict(zip(keys, info[5:]))}", flush=True)

        # inputs ---------------------------------------------------------------
        texts = main_corpus(args.texts, 17)
        rng = np.random.RandomState(17)
        vocabs = {}
        for label, path in (("50K", TOKENIZER_JSON), ("100K", TOKENIZER_100K)):
            tok = Tokenizer.from_file(path)
            rows = _with_specials(tok, tok.encode_batch(texts, backend="native"))
            vocabs[label] = (vocab_tensors(tok.id_to_token_map, tok.special_tokens.values()), rows,
                             sorted(tok.special_tokens.values()))
        vr, sp = long_token_vocab()
        vocabs["long"] = (vocab_tensors(vr, sp), None, sp)
        batches: dict = {}
        graph_pairs: dict = {}
        for label, ((tabs, entries, max_len), rows, special) in vocabs.items():
            V = tabs[2].numel()
            b = batches.setdefault(label, [])
            if rows is not None:
                b.append(("corpus rows", *_ragged_on_card(rows)))
            for B, T in ((8192, 128), (16, 4096)) if label != "long" else ((64, 300), (3, 5000)):
                rand = rng.randint(-3, V + 3, size=(B, T)) if label == "long" else rng.randint(0, V, size=(B, T))
                rand[rng.rand(B, T) < 0.01] = rng.choice(special, size=1)[0]
                ids = torch.from_numpy(rand.astype(np.int32).ravel()).cuda()
                b.append((f"random ids [{B},{T}]",
                          ids, torch.arange(0, B * T + 1, T, dtype=torch.int64, device="cuda")))
            b.append(("edge rows", *_ragged_on_card(_decode_edge_rows(V, special, rng))))
            if label == "long":
                # tile 1 starts at every residue mod 16: r one-byte ids
                # (id 1), the rest of tile 0 missing ids (no bytes)
                for r in range(16):
                    row = [1] * r + [15] * (1024 - r) + rng.randint(0, V, size=700).tolist()
                    b.append((f"residue {r}", *_ragged_on_card([[], row[:1500], row[1500:], []])))
                b.append(("all dropped", *_ragged_on_card([[-1] * 3000, [V] * 5])))
                b.append(("one id", *_ragged_on_card([[2]])))
                for n in (2048, 2049):
                    b.append((f"{n} ids", *_ragged_on_card([rng.randint(0, V, size=n).tolist()])))
                ids_a, offs = _ragged_on_card([rng.randint(0, V, size=3000).tolist(), [], [9, 9]])
                ids_b = torch.from_numpy(rng.randint(0, V, size=ids_a.numel()).astype(np.int32)).cuda()
                graph_pairs[label] = [(ids_a, ids_b, offs)]

        designs = {}
        for label, ((tabs, entries, max_len), _rows, _sp) in vocabs.items():
            for name, (lib, _log) in libs.items():
                designs[(label, name)] = Design(name, lib, name.startswith("parent"), tabs,
                                                entries, max_len)
        checks = 0
        for (label, name), d in designs.items():
            if name == "parent-split" or name.startswith("x-"):
                continue
            checks += check_design(d, batches[label], graph_pairs.get(label, []))
        print(f"checks: {checks}, every design equal to the plain version ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        if args.time == "none":
            return 0

        # Step 0: the parent's three nodes, each alone -----------------------
        times: dict = {}
        if args.parent:
            for label, bname in (("50K", "corpus rows"), ("50K", "random ids [8192,128]"),
                                 ("100K", "corpus rows")):
                d = designs[(label, "parent-split")]
                _, ids, offs = next(x for x in batches[label] if x[0] == bname)
                n, B = ids.numel(), offs.numel() - 1
                total = d(ids, offs, False).numel() - 8 * (B + 1)
                lib, sc = d.lib, d.scratch
                lib.study_memset.argtypes = (P, L, P)
                lib.study_totals.argtypes = (P, L, P, P, I, I, P, P)
                out = torch.empty(8 * (B + 1) + total, dtype=torch.uint8, device="cuda")

                def memset():
                    lib.study_memset(sc.data_ptr(), n, torch.cuda.current_stream().cuda_stream)

                def totals():
                    lib.study_totals(ids.data_ptr(), n, d.offsets.data_ptr(), d.special.data_ptr(),
                                     d.V, 0, sc.data_ptr(), torch.cuda.current_stream().cuda_stream)

                def scatter():
                    lib.ctok_decode_scatter(ids.data_ptr(), n, offs.data_ptr(), B, d.arena.data_ptr(),
                                            d.offsets.data_ptr(), d.special.data_ptr(), d.V, 0,
                                            sc.data_ptr(), out.data_ptr(),
                                            torch.cuda.current_stream().cuda_stream)

                whole = designs[(label, "parent")]
                split = {}
                for _ in range(args.rounds):
                    for node, fn in (("memset", memset), ("totals + last-block scan", totals),
                                     ("scatter", scatter),
                                     ("whole (3 nodes)", lambda: whole(ids, offs, False, total=total))):
                        split.setdefault(node, []).append(_time_ms(fn, 200))
                key = f"Step 0, {label} {bname} [{B} rows, {n} ids]"
                times[key] = split
                print(key + ": " + "  ".join(f"{k} {min(v):.4f}-{max(v):.4f}" for k, v in split.items())
                      + " ms", flush=True)

        # the designs in turns, warm and cold --------------------------------
        shapes = [] if args.time == "step0" else [("50K", "corpus rows"), ("100K", "corpus rows"), ("50K", "random ids [8192,128]"),
                  ("100K", "random ids [8192,128]"), ("50K", "random ids [16,4096]"),
                  ("long", "random ids [64,300]")]
        names = [n for n in libs if n != "parent-split"]
        for label, bname in shapes:
            _, ids, offs = next(x for x in batches[label] if x[0] == bname)
            n, B = ids.numel(), offs.numel() - 1
            key = f"{label} {bname} [{B} rows, {n} ids]"
            row = times.setdefault(key, {})
            for _ in range(args.rounds):
                for name in names:
                    d = designs[(label, name)]
                    total = d(ids, offs, False).numel() - 8 * (B + 1) if d.parent else None
                    reps = 50 if n >= 1 << 18 else 200

                    def fn(i, o, d=d, total=total):
                        return d(i, o, False, total=total)

                    warm = _time_ms(lambda: fn(ids, offs), reps)
                    out_bytes = 8 * (B + 1) + (total if d.parent else n * d.max_len)
                    sets = _cold_sets((ids, offs), out_bytes)
                    cold = _time_cold_ms(fn, sets, reps)
                    del sets
                    row.setdefault(name, []).append([warm, cold])
            print(key + ": " + "  ".join(
                f"{k} warm {min(w for w, _ in v):.4f}-{max(w for w, _ in v):.4f} cold "
                f"{min(c for _, c in v):.4f}-{max(c for _, c in v):.4f}" for k, v in row.items())
                + " ms", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "power": smi, "times_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
