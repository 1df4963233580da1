"""The native corpus tokenizer, built from this package's C source at its
first use.

``tokenize_corpus(texts, stoi, max_len)`` turns space-separated residue
texts into an int32 [n, max_len] matrix, each row [START] + tokens +
[EOS] + PAD, equal to ``Vocab.to_ix(text, fix_length=max_len)`` row by
row (``tokenize_corpus_reference``, the plain version, which the tests
and chip_smoke.py reach by name and nothing else calls). The source is ``_tokenizer.c``, a
CPython extension (the port's copy of the JAX package's native
tokenizer). The first call compiles it with ``$CC`` (gcc by default),
``-O3 -shared -fPIC`` and the interpreter's include directory into
``build/torch_native/`` at the repository root (listed in .gitignore),
keyed by a hash of the source, the compiler command and the interpreter's
extension suffix, and loads it; later calls and processes reuse the file.
Parallel first calls (test workers, spawned ranks) each compile to a name
of their own and ``os.replace`` it into place, so no process loads a
half-written library. A failed build raises with the compiler's output:
there is no quiet switch to the Python path.
"""

import hashlib
import importlib.machinery
import importlib.util
import os
import shlex
import subprocess
import sysconfig
import threading

import numpy as np

from ..data.vocab import EOS_IDX, PAD_IDX, START_IDX, UNK_IDX

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "_tokenizer.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_native")
FLAGS = ["-O3", "-shared", "-fPIC"]

_ext = None
_lock = threading.Lock()


def _command(out):
    cc = shlex.split(os.environ.get("CC", "gcc"))
    include = sysconfig.get_paths()["include"]
    return [*cc, *FLAGS, f"-I{include}", SOURCE, "-o", out]


def library_path():
    """Where the build of the current source and compiler goes."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    digest = hashlib.sha256(" ".join(_command("")).encode())
    digest.update(suffix.encode())
    with open(SOURCE, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"_tokenizer_{digest.hexdigest()[:16]}{suffix}")


def build():
    """Compile the extension (skipped when its file exists) and load it.
    Returns the extension module; raises RuntimeError with the compiler's
    output if the build fails."""
    global _ext
    with _lock:
        if _ext is not None:
            return _ext
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = _command(tmp)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=300)
            except OSError as e:
                raise RuntimeError(
                    f"native tokenizer build failed: {' '.join(cmd)}: "
                    f"{e}") from e
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(
                    f"native tokenizer build failed ({proc.returncode}): "
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        name = f"{__name__}._tokenizer"
        loader = importlib.machinery.ExtensionFileLoader(name, so)
        spec = importlib.util.spec_from_file_location(name, so,
                                                      loader=loader)
        module = importlib.util.module_from_spec(spec)
        loader.exec_module(module)
        _ext = module
        return module


def tokenize_corpus(texts, stoi, max_len):
    """list[str] (space-separated residue tokens) -> int32 [n, max_len]."""
    raw = build().tokenize_corpus(list(texts), dict(stoi), int(max_len),
                                  PAD_IDX, START_IDX, EOS_IDX, UNK_IDX)
    return np.frombuffer(raw, dtype="<i4").reshape(
        len(texts), int(max_len)).copy()


def tokenize_corpus_reference(texts, vocab, max_len):
    """Plain version: ``vocab.to_ix`` row by row."""
    out = np.full((len(texts), int(max_len)), PAD_IDX, dtype=np.int32)
    for row, text in enumerate(texts):
        out[row] = vocab.to_ix(text, fix_length=int(max_len))
    return out
