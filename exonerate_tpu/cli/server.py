"""exonerate-server: serve a sequence database + word index over TCP
(ref: src/program/exonerate-server.c; protocol lines 209-248).

Text line protocol: help, version, exit, dbinfo, lookup <eid>,
get info|seq|subseq, set query <seq>, set param <k> <v>,
revcomp query|target, get hsps.
"""
from __future__ import annotations

import socket
import socketserver
import sys
import threading

from ..alphabet import Alphabet, AlphabetType, guess_type
from ..db.dataset import Dataset, dataset_build
from ..db.index import Index, index_build
from ..model.match import Match, MatchArgs, MatchType, match_type_find
from ..seeds.hsp import HspArgs, HspParam, HspSet
from ..seeds.wordhood import WordHood
from ..seqio import Sequence
from .. import __version__
from . import args as A

_INT_PARAMS = {
    "seedrepeat": "seed_repeat",
    "dnahspthreshold": "dna_hsp_threshold",
    "proteinhspthreshold": "protein_hsp_threshold",
    "codonhspthreshold": "codon_hsp_threshold",
    "dnawordlimit": "dna_word_limit",
    "proteinwordlimit": "protein_word_limit",
    "codonwordlimit": "codon_word_limit",
    "geneseedthreshold": "geneseed_threshold",
    "geneseedrepeat": "geneseed_repeat",
    "dnahspdropoff": "dna_hsp_dropoff",
    "proteinhspdropoff": "protein_hsp_dropoff",
    "codonhspdropoff": "codon_hsp_dropoff",
}


class Connection:
    def __init__(self, server):
        self.server = server
        self.query: Sequence | None = None
        self.query_type: AlphabetType | None = None
        self.revcomp_target = False
        self.hsp_args = HspArgs()
        self.max_query_span = 0
        self.max_target_span = 0

    # -- command handlers --------------------------------------------------

    def handle(self, line: str) -> str | None:
        words = line.split()
        if not words:
            return ""
        cmd = words[0].lower()
        if cmd == "help":
            return HELP_TEXT
        if cmd == "version":
            return f"version: exonerate-server {__version__}\n"
        if cmd == "exit":
            return None
        if cmd == "dbinfo":
            ds = self.server.dataset
            lens = ds.lengths
            return ("dbinfo: %s %s %d %d %d\n" % (
                ds.types[0] if ds.types else "dna",
                "softmasked", len(ds),
                int(lens.max()) if len(lens) else 0,
                int(lens.sum()) if len(lens) else 0))
        if cmd == "lookup" and len(words) == 2:
            num = self.server.dataset.lookup(words[1])
            if num < 0:
                return f"error: id not found [{words[1]}]\n"
            return f"lookup: {num}\n"
        if cmd == "get" and len(words) >= 3:
            return self._handle_get(words[1].lower(), words[2:])
        if cmd == "get" and len(words) == 2 and words[1] == "hsps":
            return self._get_hsps()
        if cmd == "set" and len(words) >= 3:
            return self._handle_set(words[1].lower(), words[2:])
        if cmd == "revcomp" and len(words) == 2:
            if words[1] == "query":
                if self.query is None:
                    return "error: no query set\n"
                self.query = self.query.revcomp()
                self.revcomp_query = not getattr(self, "revcomp_query",
                                                 False)
                return "ok: query strand %s\n" % (
                    "revcomp" if self.revcomp_query else "forward")
            if words[1] == "target":
                self.revcomp_target = not self.revcomp_target
                return "ok: target strand %s\n" % (
                    "revcomp" if self.revcomp_target else "forward")
        return f"error: unknown command [{line}]\n"

    def _handle_get(self, what, rest) -> str:
        ds = self.server.dataset
        if what == "hsps":
            return self._get_hsps()
        try:
            num = int(rest[0])
        except (ValueError, IndexError):
            return "error: bad sequence num\n"
        if not (0 <= num < len(ds)):
            return f"error: sequence num out of range [{num}]\n"
        if what == "info":
            d = ds.defs[num]
            return "seqinfo: %d %d %s%s%s\n" % (
                int(ds.lengths[num]), int(ds.checksums[num]),
                ds.ids[num], " " if d else "", d or "")
        if what == "seq":
            return "seq: %s\n" % ds.get_sequence(num).data.tobytes(
                ).decode()
        if what == "subseq" and len(rest) == 3:
            start, ln = int(rest[1]), int(rest[2])
            if ln <= 0:
                return f"error: subseq len ({ln}) must be >= 0\n"
            if start < 0 or start + ln > int(ds.lengths[num]):
                return ("error: subsequence beyond seq len [%d]\n"
                        % int(ds.lengths[num]))
            return "subseq: %s\n" % ds.get_subseq(num, start, ln).decode()
        return "error: bad get command\n"

    def _handle_set(self, what, rest) -> str:
        if what == "query":
            seq = "".join(rest)
            qt = guess_type(seq.encode())
            self.query = Sequence("query", None, seq, Alphabet(qt), "+")
            self.query_type = qt
            self.revcomp_query = False
            # (ref: exonerate-server.c:779-781: "ok: <len> <checksum>")
            return "ok: %d %d\n" % (len(seq),
                                     self.query.gcg_checksum())
        if what == "param" and len(rest) == 2:
            name, value = rest[0].lower(), rest[1]
            if name == "querytype":
                self.query_type = (AlphabetType.DNA if value == "dna"
                                   else AlphabetType.PROTEIN)
                return "ok: set\n"
            if name == "maxqueryspan":
                self.max_query_span = int(value)
                return "ok: set\n"
            if name == "maxtargetspan":
                self.max_target_span = int(value)
                return "ok: set\n"
            attr = _INT_PARAMS.get(name)
            if attr:
                setattr(self.hsp_args, attr, int(value))
                return "ok: set\n"
            return f"warning: set param {name} ignored by server\n"
        return "error: bad set command\n"

    def _hsp_param(self):
        """Match/HSP parameters for the current query vs this index
        (translated indexes serve protein queries as protein2dna,
        ref: index.c:945-948 protein VFSM alphabet)."""
        srv = self.server
        if srv.index.translated:
            if self.query.alphabet.type != AlphabetType.PROTEIN:
                return None
            match_type = match_type_find(AlphabetType.PROTEIN,
                                         AlphabetType.DNA, False)
        else:
            match_type = match_type_find(
                self.query.alphabet.type, AlphabetType.DNA, False)
        param = HspParam(Match(match_type, MatchArgs()), self.hsp_args)
        param.wordlen = srv.index.wordlen
        return param

    def _build_hspsets(self, param, seeds_by_target) -> dict:
        """Server-side extension: seed + x-drop + finalise per target
        (ref: Index_get_HSPset, index.c:1290-1320)."""
        from ..db.index import qy_page_order
        srv = self.server
        out = {}
        # first-seen target order from the word-seed scan, NOT sorted:
        # the C server appends targets to target_id_list on first
        # encounter while walking the word seed list and every later
        # stage preserves that order (ref: index.c:1358-1399,
        # Index_Geneseed_collect_hsps index.c:1894-1911)
        for tid in seeds_by_target:
            target = srv.dataset.get_sequence(tid)
            if self.revcomp_target:
                target = target.revcomp()
            hs = HspSet(self.query, target, param)
            pairs = seeds_by_target[tid]
            if self.revcomp_target and not srv.index.translated:
                pairs = [(q, len(target) - t - param.wordlen)
                         for q, t in pairs]
            hs.seed_qy_sorted(qy_page_order(pairs, hs.qadv, hs.tadv,
                                            len(target)))
            hs.finalise()
            if hs.hsps:
                out[tid] = hs
        return out

    def _get_hsps(self) -> str:
        if self.query is None:
            return "error: no query set\n"
        srv = self.server
        param = self._hsp_param()
        if param is None:
            return ("error: translated index requires a protein query\n")
        if self.revcomp_target and param.match.type.name != "PROTEIN2DNA":
            # (ref: exonerate-server.c:322-325)
            return ("error: revcomp target only available for "
                    "protein2dna matches\n")
        wordhood = WordHood.for_param(param)
        gs = getattr(self.hsp_args, "geneseed_threshold", 0)
        if gs > 0:
            if gs < param.threshold:
                # (ref: exonerate-server.c:327-330)
                return ("error: geneseed threshold must be >= hsp "
                        "threshold\n")
            hspsets = self._get_hsps_geneseed(param, wordhood)
        else:
            seeds_by_target = srv.index.get_hsp_seeds(
                self.query, wordhood,
                revcomp_target=self.revcomp_target,
                device_index=srv.device_index)
            hspsets = self._build_hspsets(param, seeds_by_target)
        parts = []
        for tid in hspsets:          # first-seen order (see above)
            hs = hspsets[tid]
            seg = ["hspset: %d" % tid]
            for h in hs.hsps:
                seg.append(" %d %d %d" % (h.query_start,
                                          h.target_start, h.length))
            parts.append("".join(seg))
        if not parts:
            return "hspset: empty\n"
        return "\n".join(parts) + "\n"

    def _get_hsps_geneseed(self, param, wordhood) -> dict:
        """Two-tier geneseed seeding (ref: Index_get_HSPsets_geneseed,
        index.c:1924-1975): a sparse first pass at the geneseed
        threshold/repeat anchors loci; iterative interval-restricted
        subseed passes at the normal threshold then pull in nearby HSPs
        via RangeTree-style geometry until no new regions appear."""
        srv = self.server
        gs_param = HspParam(param.match, self.hsp_args)
        gs_param.wordlen = srv.index.wordlen
        gs_param.threshold = self.hsp_args.geneseed_threshold
        gs_param.seed_repeat = getattr(self.hsp_args,
                                       "geneseed_repeat", 3)
        seeds_by_target = srv.index.get_hsp_seeds(
            self.query, wordhood, revcomp_target=self.revcomp_target,
            device_index=srv.device_index)
        anchors = self._build_hspsets(gs_param, seeds_by_target)
        if not anchors:
            return {}
        # per-target geneseed state (ref: Index_Geneseed).  The keeper
        # and candidate sets are faithful RangeTrees (glibc tsearch
        # recent set + kd-tree) so the collected HSP byte ORDER matches
        # the C server exactly (rangetree.c root-eviction + in-order)
        from ..db.rangetree import RangeTree
        state = {}
        for tid, hs in anchors.items():
            keepers = RangeTree()
            for h in hs.hsps:
                keepers.add(self._q_cobs(hs, h), self._t_cobs(hs, h), h)
            state[tid] = dict(
                keepers=keepers,
                cand=RangeTree(),
                max_cobs=None,
                covered=[],           # merged [start, end) intervals
                subseeds=[(h, True, True) for h in hs.hsps],
                hs=hs)
        while True:
            intervals = {}
            for tid, st in state.items():
                new = self._geneseed_regions(st)
                if new:
                    intervals[tid] = new
            if not intervals:
                break
            sub_seeds = srv.index.get_hsp_seeds(
                self.query, wordhood,
                revcomp_target=self.revcomp_target,
                intervals=intervals, device_index=srv.device_index)
            subs = self._build_hspsets(param, sub_seeds)
            if not subs:
                for st in state.values():
                    st["subseeds"] = []
                break
            self._geneseed_refine(state, subs)
        # collect keepers per target, re-finalised, in kd-tree in-order
        # (ref: Index_Geneseed_collect_hspset, index.c:1560-1580)
        out = {}
        for tid, st in state.items():
            if st["keepers"].is_empty():
                continue
            hs = HspSet(self.query, st["hs"].target, param)
            st["keepers"].traverse(
                lambda x, y, h, _hs=hs: _hs.add_known_hsp(
                    h.query_start, h.target_start, h.length) and False)
            hs.finalise()
            if hs.hsps:
                out[tid] = hs
        return out

    @staticmethod
    def _q_cobs(hs, h):
        return h.query_start + h.cobs * hs.qadv

    @staticmethod
    def _t_cobs(hs, h):
        return h.target_start + h.cobs * hs.tadv

    def _geneseed_regions(self, st) -> list:
        """New (uncovered) target intervals around current subseeds
        (ref: Index_Geneseed_get_regions, index.c:1659-1695)."""
        hs = st["hs"]
        tlen = len(hs.target)
        spans = []
        for h, go_fwd, go_rev in st["subseeds"]:   # list order (ref)
            t_cobs = self._t_cobs(hs, h)
            rng = self.max_target_span \
                + (t_cobs - h.target_start) * 2
            if go_rev:
                start = max(0, t_cobs - rng)
                spans.append((start, t_cobs))
            if go_fwd:
                end = min(tlen, t_cobs + rng)
                spans.append((t_cobs, end))
        # subtract already-covered intervals, then extend the coverage
        # (the NOI-tree delta: only newly covered ranges are searched)
        new = _interval_subtract(_interval_merge(spans), st["covered"])
        st["covered"] = _interval_merge(st["covered"] + spans)
        return [(s, e - s) for s, e in new if e > s]

    def _geneseed_refine(self, state, subs):
        """(ref: Index_Geneseed_refine_subseeds, index.c:1813-1905).
        Candidate search runs through the faithful RangeTree so new
        keepers arrive in the C server's kd-tree find order."""
        for tid, hs in subs.items():
            st = state.get(tid)
            if st is None or not st["subseeds"]:
                continue
            src = st["hs"]
            cand = st["cand"]
            keepers = st["keepers"]
            for h in hs.hsps:
                cq, ct = self._q_cobs(hs, h), self._t_cobs(hs, h)
                if not cand.check_pos(cq, ct):
                    cand.add(cq, ct, h)
                if st["max_cobs"] is None \
                        or st["max_cobs"].cobs < h.cobs:
                    st["max_cobs"] = h
            nxt = []
            mc = st["max_cobs"]

            def report(fwd):
                def cb(x, y, c):
                    if not keepers.check_pos(x, y):
                        keepers.add(x, y, c)
                        nxt.append((c, fwd, not fwd))
                    return False
                return cb

            for h, go_fwd, go_rev in st["subseeds"]:
                q_cobs = self._q_cobs(src, h)
                t_cobs = self._t_cobs(src, h)
                q_rng = self.max_query_span + (
                    (h.query_end(src.qadv) - q_cobs)
                    + (self._q_cobs(hs, mc) - mc.query_start)) * 2
                t_rng = self.max_target_span + (
                    (h.target_end(src.tadv) - t_cobs)
                    + (self._t_cobs(hs, mc) - mc.target_start)) * 2
                if go_fwd:
                    cand.find(q_cobs, q_rng, t_cobs, t_rng,
                              report(True))
                if go_rev:
                    cand.find(q_cobs - q_rng, q_rng,
                              t_cobs - t_rng, t_rng, report(False))
            st["subseeds"] = nxt


HELP_TEXT = (
    "exonerate-server commands:\n"
    "    help    : print this message\n"
    "    version : show version information\n"
    "    exit    : disconnect from server\n"
    "    dbinfo  : show database info\n"
    "    lookup <eid> : get internal from external identifier\n"
    "    get info <iid> : get sequence info\n"
    "    get seq <iid> : get sequence\n"
    "    get subseq <iid> <start> <len> : get subsequence\n"
    "    set query <seq> : set query sequence\n"
    "    get hsps : get hsps against current query\n"
    "    revcomp <query | target>\n"
    "    set param <name> <value>\n"
    "--\n")


class ExonerateServer:
    def __init__(self, dataset: Dataset, index: Index, port: int = 12886,
                 verbosity: int = 0, use_device_index: bool = False,
                 max_connections: int = 4):
        self.dataset = dataset
        self.index = index
        self.port = port
        self.verbosity = verbosity
        self.max_connections = max(1, int(max_connections))
        self._httpd = None
        self.device_index = None
        if use_device_index:
            # postings sharded over every attached device; `get hsps`
            # word lookups become one collective gather per query
            # (ref: the serving loop exonerate-server.c:315-378 —
            # the device replacement for its postings scan)
            import jax
            import numpy as np
            from jax.sharding import Mesh
            from ..db.device_index import DeviceIndex
            devs = np.array(jax.devices())
            mesh = Mesh(devs.reshape(-1), ("dp",))
            self.device_index = DeviceIndex(index, mesh)

    def serve_forever(self):
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                conn = Connection(outer)
                while True:
                    raw = self.rfile.readline()
                    if not raw:
                        break
                    reply = conn.handle(raw.decode().strip())
                    if reply is None:
                        self.wfile.write(b"ok: exiting\n")
                        break
                    # multi-line replies are framed with a linecount:
                    # header exactly like the reference Socket_send
                    # (ref: src/general/socket.c:160-172): the value
                    # counts the reply's lines plus the header itself,
                    # letting clients read without timeouts
                    n = reply.count("\n")
                    if n > 1:
                        self.wfile.write(f"linecount: {n + 1}\n".encode())
                    self.wfile.write(reply.encode())
                    self.wfile.flush()

        # --maxconnections bounds concurrent connection threads the
        # same way the reference counts active connections and rejects
        # beyond the limit (ref: exonerate-server.c:866-877); a
        # semaphore gate makes excess connections wait in the accept
        # queue instead
        conn_gate = threading.BoundedSemaphore(self.max_connections)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

            def process_request(self, request, client_address):
                conn_gate.acquire()
                try:
                    super().process_request(request, client_address)
                except BaseException:
                    conn_gate.release()
                    raise

            def process_request_thread(self, request, client_address):
                try:
                    super().process_request_thread(request,
                                                   client_address)
                finally:
                    conn_gate.release()

        self._httpd = Server(("0.0.0.0", self.port), Handler)
        self._httpd.serve_forever()

    def start_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        if self._httpd:
            self._httpd.shutdown()


def main(argv=None, out=None):
    from .. import enable_compilation_cache
    enable_compilation_cache()
    argv = argv if argv is not None else sys.argv[1:]
    out = out or sys.stdout
    p = A.ArgumentParser("exonerate-server",
                         "serve sequence databases for exonerate clients")
    aset = A.ArgumentSet("Server options")
    aset.add(None, "port", "port", "Port number to run server on",
             "12886", A.parse_int, "port")
    aset.add(None, "input", "path", "esd file (or fasta to build from)",
             None, A.parse_string, "input")
    aset.add(None, "proteinquery", None, "Index for protein queries",
             "FALSE", A.parse_boolean, "proteinquery")
    aset.add(None, "maxconnections", "n", "Maximum concurrent connections",
             "4", A.parse_int, "maxconnections")
    aset.add(None, "preload", None, "Preload the database", "TRUE",
             A.parse_boolean, "preload")
    aset.add(None, "deviceindex", None,
             "Serve word lookups from the device-sharded index",
             "FALSE", A.parse_boolean, "deviceindex")
    aset.add("V", "verbosity", "level", "Verbosity level", "1",
             A.parse_int, "verbosity")
    p.add_set(aset)
    v = p.parse(argv)
    pos = v.get("_positional", [])
    path = v["input"] or (pos[0] if pos else None)
    if not path:
        raise SystemExit("exonerate-server: need an esd/esi input")
    if path.endswith(".esi") or path.endswith(".esi.npz"):
        index = Index(path)
        dataset = index.dataset
    else:
        # build in-memory from fasta / esd
        import tempfile, os
        tmp = tempfile.mkdtemp()
        esd = path
        if not (path.endswith(".esd") or path.endswith(".esd.npz")):
            esd = os.path.join(tmp, "db.esd.npz")
            dataset_build([path], esd)
        esi = os.path.join(tmp, "db.esi.npz")
        index_build(esd, esi, translated=v["proteinquery"])
        index = Index(esi)
        dataset = index.dataset
    out.write(f"listening on port {v['port']}\n")
    srv = ExonerateServer(dataset, index, v["port"], v["verbosity"],
                          use_device_index=v["deviceindex"],
                          max_connections=v["maxconnections"])
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())


def _interval_merge(spans):
    """Merge [start, end) spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _interval_subtract(spans, covered):
    """spans minus covered, both merged [start, end) lists."""
    out = []
    ci = 0
    for s, e in spans:
        cur = s
        while ci < len(covered) and covered[ci][1] <= cur:
            ci += 1
        k = ci
        while cur < e:
            if k >= len(covered) or covered[k][0] >= e:
                out.append((cur, e))
                break
            cs, ce = covered[k]
            if cs > cur:
                out.append((cur, cs))
            cur = max(cur, ce)
            k += 1
    return out
