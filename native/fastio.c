/* Native IO runtime for particle_simulation_tpu.
 *
 * Counterpart of the reference's host-side native layer:
 *   - cross-section table parsing (reference processCSData,
 *     src/cross_section.cu:3-28) — a tight fscanf-free float parser;
 *   - PNG encoding for particle-scatter snapshots (reference image()/
 *     save_png over libpng, src/utility.cu:4-74) — minimal zlib-backed
 *     encoder, no libpng dependency;
 *   - CSV appending for the benchmark sweep (reference printCSV,
 *     src/utility.cu:87-106).
 *
 * Exposed via the CPython C API (module `_fastio`); the Python wrapper in
 * particle_simulation_tpu/utils/fastio.py degrades gracefully when the
 * extension is not built.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

/* ---------------- float-pair table parser ---------------- */

static PyObject *
fastio_parse_float_pairs(PyObject *self, PyObject *args)
{
    const char *path;
    Py_ssize_t expect;
    if (!PyArg_ParseTuple(args, "sn", &path, &expect))
        return NULL;

    FILE *f = fopen(path, "rb");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }
    /* Non-seekable paths (FIFOs, ...) make ftell return -1, which would
       underflow the malloc size and overflow the fread. */
    long size = -1;
    if (fseek(f, 0, SEEK_END) == 0)
        size = ftell(f);
    if (size < 0 || fseek(f, 0, SEEK_SET) != 0) {
        fclose(f);
        PyErr_Format(PyExc_OSError, "not a seekable regular file: %s", path);
        return NULL;
    }
    char *buf = (char *)malloc((size_t)size + 1);
    if (!buf) {
        fclose(f);
        return PyErr_NoMemory();
    }
    size_t rd = fread(buf, 1, (size_t)size, f);
    fclose(f);
    buf[rd] = '\0';

    double *out = (double *)malloc(sizeof(double) * 2 * (size_t)expect);
    if (!out) {
        free(buf);
        return PyErr_NoMemory();
    }
    Py_ssize_t count = 0;
    char *p = buf;
    while (count < 2 * expect) {
        char *end;
        double v = strtod(p, &end);
        if (end == p) {
            /* skip one non-numeric char, stop at end of buffer */
            if (*p == '\0')
                break;
            p++;
            continue;
        }
        out[count++] = v;
        p = end;
    }
    free(buf);
    if (count != 2 * expect) {
        free(out);
        PyErr_Format(PyExc_ValueError,
                     "expected %zd floats in %s, found %zd",
                     2 * expect, path, count);
        return NULL;
    }
    PyObject *bytes = PyBytes_FromStringAndSize((const char *)out,
                                                (Py_ssize_t)(sizeof(double) * 2 * expect));
    free(out);
    return bytes;  /* wrapper: np.frombuffer(...).reshape(n, 2) */
}

/* ---------------- PNG encoder ---------------- */

static void put_be32(unsigned char *p, unsigned int v)
{
    p[0] = (unsigned char)(v >> 24);
    p[1] = (unsigned char)(v >> 16);
    p[2] = (unsigned char)(v >> 8);
    p[3] = (unsigned char)v;
}

static int write_chunk(FILE *f, const char *tag, const unsigned char *data,
                       size_t len)
{
    unsigned char hdr[8];
    put_be32(hdr, (unsigned int)len);
    memcpy(hdr + 4, tag, 4);
    if (fwrite(hdr, 1, 8, f) != 8)
        return -1;
    if (len && fwrite(data, 1, len, f) != len)
        return -1;
    uLong crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, (const Bytef *)tag, 4);
    if (len)
        crc = crc32(crc, data, (uInt)len);
    unsigned char crcb[4];
    put_be32(crcb, (unsigned int)crc);
    return fwrite(crcb, 1, 4, f) == 4 ? 0 : -1;
}

static PyObject *
fastio_write_png(PyObject *self, PyObject *args)
{
    const char *path;
    Py_buffer rgb;
    int w, h;
    if (!PyArg_ParseTuple(args, "sy*ii", &path, &rgb, &w, &h))
        return NULL;
    if ((Py_ssize_t)rgb.len != (Py_ssize_t)w * h * 3) {
        PyBuffer_Release(&rgb);
        PyErr_SetString(PyExc_ValueError, "buffer size != w*h*3");
        return NULL;
    }

    /* raw scanlines with filter byte 0 */
    size_t stride = (size_t)w * 3;
    size_t rawlen = ((size_t)h) * (stride + 1);
    unsigned char *raw = (unsigned char *)malloc(rawlen);
    if (!raw) {
        PyBuffer_Release(&rgb);
        return PyErr_NoMemory();
    }
    const unsigned char *src = (const unsigned char *)rgb.buf;
    for (int y = 0; y < h; y++) {
        raw[y * (stride + 1)] = 0;
        memcpy(raw + y * (stride + 1) + 1, src + y * stride, stride);
    }

    uLongf zcap = compressBound((uLong)rawlen);
    unsigned char *zbuf = (unsigned char *)malloc(zcap);
    if (!zbuf) {
        free(raw);
        PyBuffer_Release(&rgb);
        return PyErr_NoMemory();
    }
    int zrc = compress2(zbuf, &zcap, raw, (uLong)rawlen, 6);
    free(raw);
    PyBuffer_Release(&rgb);
    if (zrc != Z_OK) {
        free(zbuf);
        PyErr_SetString(PyExc_RuntimeError, "zlib compression failed");
        return NULL;
    }

    FILE *f = fopen(path, "wb");
    if (!f) {
        free(zbuf);
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }
    static const unsigned char sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    int ok = fwrite(sig, 1, 8, f) == 8;
    unsigned char ihdr[13];
    put_be32(ihdr, (unsigned int)w);
    put_be32(ihdr + 4, (unsigned int)h);
    ihdr[8] = 8;   /* bit depth */
    ihdr[9] = 2;   /* color type RGB */
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    ok = ok && write_chunk(f, "IHDR", ihdr, 13) == 0;
    ok = ok && write_chunk(f, "IDAT", zbuf, zcap) == 0;
    ok = ok && write_chunk(f, "IEND", NULL, 0) == 0;
    free(zbuf);
    fclose(f);
    if (!ok) {
        PyErr_SetString(PyExc_OSError, "short write");
        return NULL;
    }
    Py_RETURN_NONE;
}

/* ---------------- CSV appender ---------------- */

static PyObject *
fastio_append_lines(PyObject *self, PyObject *args)
{
    const char *path;
    PyObject *lines;
    if (!PyArg_ParseTuple(args, "sO", &path, &lines))
        return NULL;
    FILE *f = fopen(path, "ab");
    if (!f) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return NULL;
    }
    PyObject *iter = PyObject_GetIter(lines);
    if (!iter) {
        fclose(f);
        return NULL;
    }
    PyObject *item;
    while ((item = PyIter_Next(iter)) != NULL) {
        Py_ssize_t len;
        const char *s = PyUnicode_AsUTF8AndSize(item, &len);
        if (!s) {
            Py_DECREF(item);
            Py_DECREF(iter);
            fclose(f);
            return NULL;
        }
        fwrite(s, 1, (size_t)len, f);
        fputc('\n', f);
        Py_DECREF(item);
    }
    Py_DECREF(iter);
    fclose(f);
    if (PyErr_Occurred())
        return NULL;
    Py_RETURN_NONE;
}

static PyMethodDef FastioMethods[] = {
    {"parse_float_pairs", fastio_parse_float_pairs, METH_VARARGS,
     "parse_float_pairs(path, n) -> bytes of 2n float64"},
    {"write_png", fastio_write_png, METH_VARARGS,
     "write_png(path, rgb_bytes, width, height)"},
    {"append_lines", fastio_append_lines, METH_VARARGS,
     "append_lines(path, iterable_of_str)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef fastiomodule = {
    PyModuleDef_HEAD_INIT, "_fastio",
    "Native IO runtime (cross-section parser, PNG encoder, CSV appender)",
    -1, FastioMethods,
};

PyMODINIT_FUNC
PyInit__fastio(void)
{
    return PyModule_Create(&fastiomodule);
}
