#!/bin/bash
# Out-of-tree build of the reference exonerate C sources against the
# minimal glib shim (tools/refbuild/glibshim).  Produces reference
# binaries used ONLY to generate byte-golden outputs and baseline
# timings for the framework's parity/perf tests.  The reference source
# tree ($REF_ROOT) is never written to.
#
# Usage: tools/refbuild/build.sh [outdir] [tests]
#   default: production binaries (exonerate, server, ipcress, 24 utils)
#            into <outdir>/bin, compiled -DG_DISABLE_ASSERT like release
#            exonerate (the reference intentionally creates
#            type-mismatched self-score model data in GAM_Result_create
#            that only works with asserts compiled out).
#   tests:   the reference per-module unit tests into <outdir>/bin/tests,
#            compiled WITH asserts (they are g_assert-based).
set -euo pipefail

REF_ROOT="${REF_ROOT:?set REF_ROOT to the reference exonerate source tree}"
REF="$REF_ROOT/src"
HERE="$(cd "$(dirname "$0")" && pwd)"
OUT="${1:-$(cd "$(dirname "$0")/../.." && pwd)/build/ref}"
MODE="${2:-prod}"
BIN="$OUT/bin"

CC=${CC:-gcc}
if [ "$MODE" = "tests" ]; then
  ASSERT_FLAGS=""
  OBJ="$OUT/obj-assert"
  AR_LIB="$OUT/libexoref-assert.a"
else
  ASSERT_FLAGS="-DG_DISABLE_ASSERT"
  OBJ="$OUT/obj"
  AR_LIB="$OUT/libexoref.a"
fi
mkdir -p "$OBJ" "$BIN"

CFLAGS="-O2 -g -w -fcommon $ASSERT_FLAGS -D_GNU_SOURCE -D_XOPEN_PATH_MAX=1024 \
  -DVERSION=\"2.4.0\" -DPACKAGE=\"exonerate\" \
  -DSOURCE_ROOT_DIR=\"$REF_ROOT\" \
  -DGLIB_CFLAGS=\"-I$HERE/glibshim\" \
  -DCUSTOM_GUINT64_FORMAT=\"lu\" -DHOSTTYPE=\"linux-x86_64\" \
  -I$HERE/glibshim"
for d in struct general sequence comparison database c4 bsdp sdp model hub; do
  CFLAGS="$CFLAGS -I$REF/$d"
done

compile() {  # compile $1 -> $OBJ/<mangled>.o if stale
  local src="$1"
  local obj="$OBJ/$(echo "${src#$REF/}" | tr '/' '_' | sed 's/\.c$/.o/')"
  if [ ! -f "$obj" ] || [ "$src" -nt "$obj" ] \
     || [ "$HERE/glibshim/glib.h" -nt "$obj" ]; then
    $CC $CFLAGS -c "$src" -o "$obj"
  fi
  echo "$obj"
}

# --- shim ---
SHIM_OBJ="$OBJ/glibshim.o"
if [ ! -f "$SHIM_OBJ" ] || [ "$HERE/glibshim/glibshim.c" -nt "$SHIM_OBJ" ] \
   || [ "$HERE/glibshim/glib.h" -nt "$SHIM_OBJ" ]; then
  $CC -O2 -g -w -D_GNU_SOURCE -I"$HERE/glibshim" \
      -c "$HERE/glibshim/glibshim.c" -o "$SHIM_OBJ"
fi

# --- library objects: everything except mains/tests ---
LIB_OBJS=()
for d in struct general sequence comparison database c4 bsdp sdp model hub; do
  for src in "$REF/$d"/*.c; do
    case "$src" in
      *.test.c|*bootstrapper.c) continue ;;
    esac
    LIB_OBJS+=("$(compile "$src")")
  done
done
ar rcs "$AR_LIB" "${LIB_OBJS[@]}"

link_bin() {  # link_bin <path> <main.c>
  local dst="$1" src="$2"
  local obj
  obj=$(compile "$src")
  if [ ! -f "$dst" ] || [ "$obj" -nt "$dst" ] || [ "$AR_LIB" -nt "$dst" ]; then
    $CC $CFLAGS -rdynamic "$obj" "$AR_LIB" "$SHIM_OBJ" -lm -o "$dst"
  fi
}

if [ "$MODE" = "tests" ]; then
  mkdir -p "$BIN/tests"
  for d in struct general sequence comparison database c4 bsdp sdp model hub; do
    for src in "$REF/$d"/*.test.c; do
      [ -e "$src" ] || continue
      link_bin "$BIN/tests/$(basename "$src" .c)" "$src"
    done
  done
  echo "test binaries in $BIN/tests"
elif [ "$MODE" = "fast" ]; then
  # Compiled-models build (the reference's real production speed):
  # run the build-time bootstrapper to codegen-specialize every model's
  # DP functions, then relink exonerate with the generated archive and
  # -DUSE_COMPILED_MODELS viterbi/scheduler (ref: src/program/Makefile.am
  # BUILT_SOURCES, src/model/bootstrapper.c).
  link_bin "$BIN/bootstrapper" "$REF/model/bootstrapper.c"
  GEN="$OUT/codegen-work"
  mkdir -p "$GEN"
  if [ ! -f "$GEN/c4_model_archive.a" ]; then
    (cd "$GEN" && C4_CODEGEN_DIRECTORY="$GEN/plugins" CC="$CC" \
       CFLAGS="-O2 -w -fcommon $ASSERT_FLAGS -D_GNU_SOURCE $(for d in \
         struct general sequence comparison database c4 bsdp sdp model \
         hub; do printf ' -I%s' "$REF/$d"; done) -I$HERE/glibshim" \
       "$BIN/bootstrapper" --compiled no)
  fi
  for f in viterbi scheduler; do
    src="$REF/c4/viterbi.c"; [ "$f" = scheduler ] && src="$REF/sdp/scheduler.c"
    $CC $CFLAGS -DUSE_COMPILED_MODELS -I"$GEN" -c "$src" -o "$OBJ/${f}_compiled.o"
  done
  obj=$(compile "$REF/program/exonerate.c")
  $CC $CFLAGS -DUSE_COMPILED_MODELS -I"$GEN" -rdynamic "$obj" \
      "$OBJ/viterbi_compiled.o" "$OBJ/scheduler_compiled.o" \
      "$GEN/c4_model_archive.a" "$AR_LIB" "$SHIM_OBJ" -lm \
      -o "$BIN/exonerate-fast"
  echo "built: $BIN/exonerate-fast"
else
  link_bin "$BIN/exonerate"        "$REF/program/exonerate.c"
  # upstream off-by-one: the hsp_total loop reads pdata[len]
  # (exonerate-server.c:348 "i <= index_hsp_set_list->len"), which
  # segfaults under the shim's exact-size GPtrArray; patch a copy
  mkdir -p "$OUT/patched"
  sed 's/for(i = 0; i <= index_hsp_set_list->len; i++)/for(i = 0; i < index_hsp_set_list->len; i++)/' \
      "$REF/program/exonerate-server.c" > "$OUT/patched/exonerate-server.c"
  link_bin "$BIN/exonerate-server" "$OUT/patched/exonerate-server.c"
  link_bin "$BIN/ipcress"          "$REF/program/ipcress.c"
  for src in "$REF/util"/*.c; do
    link_bin "$BIN/$(basename "$src" .c)" "$src"
  done
  echo "built: $BIN"
fi
