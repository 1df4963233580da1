/* Native corpus tokenizer: space-separated residue text -> fixed-width
 * int32 token rows ([START] + tokens + [EOS] + PAD), equal to
 * data/vocab.py Vocab.to_ix(text, fix_length=max_len) for every str.
 * Single-character tokens go through a 256-entry LUT; longer tokens
 * through the vocab dict.
 *
 * The port's own copy of the JAX package's native/_tokenizer.c, with two
 * changes that make it equal to to_ix on any text, not only on curated
 * corpora: an ASCII row splits on every ASCII whitespace character
 * str.split() splits on (9-13, 28-31 and the space), a row with any other
 * character is split by str.split() itself (PyUnicode_Split), and the
 * tokens "<start>" and "<eos>" are dropped, as to_ix drops them.
 *
 * Returns bytes of little-endian int32 (n_rows * max_len); the Python
 * wrapper reinterprets them with numpy (no numpy C-API dependency).
 * Built at first use by native/__init__.py.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* str.isspace() of an ASCII character */
static int
ascii_space(unsigned char c)
{
    return c == ' ' || (c >= 9 && c <= 13) || (c >= 28 && c <= 31);
}

/* a token to_ix drops */
static int
dropped(const char *s, Py_ssize_t len)
{
    return (len == 7 && memcmp(s, "<start>", 7) == 0)
           || (len == 5 && memcmp(s, "<eos>", 5) == 0);
}

/* The index of one token s[0..len); -2 on a Python error. */
static int32_t
lookup(PyObject *stoi, const int32_t *lut, const char *s, Py_ssize_t len,
       int unk)
{
    if (len == 1) {
        int32_t ix = lut[(unsigned char)s[0]];
        return ix < 0 ? unk : ix;
    }
    PyObject *tok = PyUnicode_FromStringAndSize(s, len);
    if (!tok)
        return -2;
    PyObject *v = PyDict_GetItemWithError(stoi, tok);   /* borrowed */
    Py_DECREF(tok);
    if (!v)
        return PyErr_Occurred() ? -2 : unk;
    long ix = PyLong_AsLong(v);
    if (ix == -1 && PyErr_Occurred())
        return -2;
    return (int32_t)ix;
}

/* Fill row[1..] with the tokens of t; returns the next free column, or -1
 * on a Python error. */
static int
fill_row(PyObject *t, PyObject *stoi, const int32_t *lut, int max_len,
         int unk, int32_t *row)
{
    int w = 1;
    if (PyUnicode_IS_ASCII(t)) {
        Py_ssize_t slen;
        const char *s = PyUnicode_AsUTF8AndSize(t, &slen);
        if (s == NULL)
            return -1;
        Py_ssize_t p = 0;
        while (p < slen && w < max_len - 1) {
            while (p < slen && ascii_space((unsigned char)s[p]))
                p++;
            if (p >= slen)
                break;
            Py_ssize_t q = p;
            while (q < slen && !ascii_space((unsigned char)s[q]))
                q++;
            if (!dropped(s + p, q - p)) {
                int32_t ix = lookup(stoi, lut, s + p, q - p, unk);
                if (ix == -2)
                    return -1;
                row[w++] = ix;
            }
            p = q;
        }
        return w;
    }
    PyObject *parts = PyUnicode_Split(t, NULL, -1);
    if (!parts)
        return -1;
    Py_ssize_t np = PyList_GET_SIZE(parts);
    for (Py_ssize_t k = 0; k < np && w < max_len - 1; k++) {
        Py_ssize_t len;
        const char *s = PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(parts, k),
                                                &len);
        if (s == NULL) {
            Py_DECREF(parts);
            return -1;
        }
        if (dropped(s, len))
            continue;
        /* a one-byte UTF-8 token is ASCII: the LUT holds it */
        int32_t ix = lookup(stoi, lut, s, len, unk);
        if (ix == -2) {
            Py_DECREF(parts);
            return -1;
        }
        row[w++] = ix;
    }
    Py_DECREF(parts);
    return w;
}

static PyObject *
tokenize_corpus(PyObject *self, PyObject *args)
{
    PyObject *texts, *stoi;
    int max_len, pad, start, eos, unk;
    if (!PyArg_ParseTuple(args, "OOiiiii", &texts, &stoi, &max_len,
                          &pad, &start, &eos, &unk))
        return NULL;
    if (!PyDict_Check(stoi)) {
        PyErr_SetString(PyExc_TypeError, "stoi must be a dict");
        return NULL;
    }
    if (max_len < 2) {
        PyErr_SetString(PyExc_ValueError, "max_len must be >= 2");
        return NULL;
    }
    PyObject *seq = PySequence_Fast(texts, "texts must be a sequence");
    if (!seq)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

    int32_t lut[256];
    for (int i = 0; i < 256; i++)
        lut[i] = -1;
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(stoi, &pos, &key, &value)) {
        Py_ssize_t klen;
        const char *k = PyUnicode_AsUTF8AndSize(key, &klen);
        if (k == NULL) {
            Py_DECREF(seq);
            return NULL;
        }
        if (klen == 1) {
            long ix = PyLong_AsLong(value);
            if (ix == -1 && PyErr_Occurred()) {
                Py_DECREF(seq);
                return NULL;
            }
            lut[(unsigned char)k[0]] = (int32_t)ix;
        }
    }

    PyObject *out = PyBytes_FromStringAndSize(NULL,
                                              (Py_ssize_t)n * max_len * 4);
    if (!out) {
        Py_DECREF(seq);
        return NULL;
    }
    int32_t *buf = (int32_t *)PyBytes_AS_STRING(out);

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *t = PySequence_Fast_GET_ITEM(seq, i);  /* borrowed */
        if (!PyUnicode_Check(t)) {
            PyErr_Format(PyExc_TypeError, "row %zd is not a str", i);
            Py_DECREF(seq);
            Py_DECREF(out);
            return NULL;
        }
        int32_t *row = buf + (Py_ssize_t)i * max_len;
        for (int j = 0; j < max_len; j++)
            row[j] = pad;
        row[0] = start;
        int w = fill_row(t, stoi, lut, max_len, unk, row);
        if (w < 0) {
            Py_DECREF(seq);
            Py_DECREF(out);
            return NULL;
        }
        row[w] = eos;
    }
    Py_DECREF(seq);
    return out;
}

static PyMethodDef Methods[] = {
    {"tokenize_corpus", tokenize_corpus, METH_VARARGS,
     "tokenize_corpus(texts, stoi, max_len, pad, start, eos, unk) -> "
     "bytes of int32[n, max_len]"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_tokenizer",
    "native corpus tokenizer for controlled_peptide_generation_tpu_torch",
    -1, Methods,
};

PyMODINIT_FUNC
PyInit__tokenizer(void)
{
    return PyModule_Create(&moduledef);
}
