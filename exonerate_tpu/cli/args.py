"""exonerate-compatible CLI flag system.

Equivalent of the reference Argument module
(ref: src/general/argument.{h,c}): options registered in sets with
short/long names, typed parsers, defaults, per-option environment-variable
fallback (EXONERATE_<LONGNAME>), auto --help, and mandatory positional
shorthand (`exonerate query target`).
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


def parse_boolean(s: str) -> bool:
    """(ref: Argument_parse_boolean)."""
    low = s.strip().lower()
    if low in ("true", "yes", "y", "t", "1", "on"):
        return True
    if low in ("false", "no", "n", "f", "0", "off"):
        return False
    raise ValueError(f"could not parse boolean from [{s}]")


def parse_int(s: str) -> int:
    return int(s)


def parse_float(s: str) -> float:
    return float(s)


def parse_string(s: str) -> Optional[str]:
    return None if s == "NULL" else s


@dataclass
class Option:
    short: Optional[str]
    long: str
    symbol: Optional[str]
    desc: str
    default: Optional[str]
    parser: Callable[[str], Any]
    dest: str
    is_mandatory: bool = False
    takes_value: bool = True


@dataclass
class ArgumentSet:
    name: str
    options: list[Option] = field(default_factory=list)

    def add(self, short, long, symbol, desc, default, parser,
            dest=None, mandatory=False):
        self.options.append(Option(short, long, symbol, desc, default,
                                   parser, dest or long.replace("-", "_"),
                                   mandatory))


class ArgumentParser:
    def __init__(self, prog: str, desc: str = ""):
        self.prog = prog
        self.desc = desc
        self.sets: list[ArgumentSet] = []
        self.values: dict[str, Any] = {}

    def add_set(self, aset: ArgumentSet):
        self.sets.append(aset)

    def _all_options(self):
        for aset in self.sets:
            yield from aset.options

    def _find(self, name: str, is_short: bool) -> Option:
        matches = []
        for opt in self._all_options():
            if is_short and opt.short == name:
                return opt
            if not is_short and opt.long == name:
                return opt
            if not is_short and opt.long.startswith(name):
                matches.append(opt)
        if len(matches) == 1:
            return matches[0]
        flag = ("-" if is_short else "--") + name
        if matches:
            raise SystemExit(
                f"{self.prog}: ambiguous option {flag}: "
                + ", ".join("--" + m.long for m in matches))
        raise SystemExit(f"{self.prog}: unknown option {flag}")

    def parse(self, argv: list[str]) -> dict[str, Any]:
        # defaults + env fallback (ref: exonerate.1:102-106)
        for opt in self._all_options():
            env = os.environ.get("EXONERATE_" + opt.long.upper())
            raw = env if env is not None else opt.default
            if raw is None:
                self.values[opt.dest] = None
            else:
                self.values[opt.dest] = opt.parser(raw)
        positional: list[str] = []
        i = 0
        while i < len(argv):
            a = argv[i]
            if a == "--help":
                self.print_help()
                raise SystemExit(0)
            if a in ("--shorthelp", "-h"):
                # (ref: argument.c:208-212 -h/--shorthelp)
                self.print_help(short=True)
                raise SystemExit(0)
            if a == "--version" or a == "-v":
                from .. import __version__
                print(f"{self.prog} from exonerate-tpu version "
                      f"{__version__}")
                raise SystemExit(0)
            if a.startswith("--"):
                opt = self._find(a[2:], False)
                vals = []
                j = i + 1
                while j < len(argv) and not _looks_like_flag(argv[j]):
                    vals.append(argv[j])
                    j += 1
                    if not _is_list_option(opt):
                        break
                if not vals:
                    raise SystemExit(
                        f"{self.prog}: option --{opt.long} needs a value")
                self._assign(opt, vals)
                i = j
            elif a.startswith("-") and len(a) > 1 and not _is_number(a):
                opt = self._find(a[1:], True)
                vals = []
                j = i + 1
                while j < len(argv) and not _looks_like_flag(argv[j]):
                    vals.append(argv[j])
                    j += 1
                    if not _is_list_option(opt):
                        break
                if not vals:
                    raise SystemExit(
                        f"{self.prog}: option -{opt.short} needs a value")
                self._assign(opt, vals)
                i = j
            else:
                positional.append(a)
                i += 1
        self.values["_positional"] = positional
        return self.values

    def _assign(self, opt: Option, vals: list[str]):
        if _is_list_option(opt):
            self.values[opt.dest] = [opt.parser(v) for v in vals]
        else:
            self.values[opt.dest] = opt.parser(vals[0])

    def print_help(self, short: bool = False):
        print(f"{self.prog}: {self.desc}\n")
        print(f"Usage: {self.prog} [options] <files>\n")
        for aset in self.sets:
            print(f"{aset.name}:")
            for opt in aset.options:
                shortf = f"-{opt.short} " if opt.short else ""
                if short:
                    print(f"  {shortf}--{opt.long}")
                    continue
                sym = f" <{opt.symbol}>" if opt.symbol else ""
                default = (f" [default: {opt.default}]"
                           if opt.default is not None else "")
                first_line = opt.desc.splitlines()[0]
                print(f"  {shortf}--{opt.long}{sym}  {first_line}{default}")
            print()


def _looks_like_flag(s: str) -> bool:
    return s.startswith("-") and len(s) > 1 and not _is_number(s)


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _is_list_option(opt: Option) -> bool:
    return opt.symbol in ("paths", "files")
