// The serving path's lists of ids, built with the Python C API.
//
// zbpe_lists turns B rows of int32 ids (a CPU [B, L] array with a row
// stride) and their lengths into a Python list of B lists of ints. An id
// in [0, T) becomes a new reference to table[id], where table is a list
// that holds at least the ints 0..T-1 and that the caller keeps alive, so
// building a row allocates one list and no int, and releasing it frees no
// int. An id outside [0, T) is made anew with PyLong_FromLong, so the
// values are exact whatever the rows hold. counts[0] gets the ids taken
// from the table, counts[1] those made anew.
//
// Called through ctypes.PyDLL, with the interpreter lock held. Returns a
// new reference, or NULL with a Python exception set.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>

extern "C" PyObject* zbpe_lists(const int32_t* rows, int64_t n_rows, int64_t width,
                                int64_t stride, const int32_t* lengths, PyObject* table,
                                int64_t T, int64_t* counts) {
    if (!PyList_Check(table) || PyList_GET_SIZE(table) < T) {
        PyErr_Format(PyExc_ValueError, "table must be a list of at least %lld ints",
                     (long long)T);
        return NULL;
    }
    for (int64_t i = 0; i < n_rows; ++i) {
        if (lengths[i] < 0 || lengths[i] > width) {
            PyErr_Format(PyExc_ValueError, "length %d of row %lld outside [0, %lld]",
                         (int)lengths[i], (long long)i, (long long)width);
            return NULL;
        }
    }
    PyObject* out = PyList_New((Py_ssize_t)n_rows);
    if (out == NULL) return NULL;
    int64_t shared = 0, made = 0;
    for (int64_t i = 0; i < n_rows; ++i) {
        const int32_t* row = rows + i * stride;
        const Py_ssize_t n = lengths[i];
        PyObject* list = PyList_New(n);
        if (list == NULL) {
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, i, list);
        // read after each allocation, which may run a collection and any
        // finaliser it calls
        PyObject** ints = PySequence_Fast_ITEMS(table);
        for (Py_ssize_t j = 0; j < n; ++j) {
            const int32_t id = row[j];
            PyObject* v;
            if (id >= 0 && id < T) {
                v = ints[id];
                Py_INCREF(v);
                ++shared;
            } else {
                v = PyLong_FromLong(id);
                if (v == NULL) {
                    Py_DECREF(out);  // the unfilled items are NULL, which a list frees as none
                    return NULL;
                }
                ++made;
            }
            PyList_SET_ITEM(list, j, v);
        }
    }
    counts[0] = shared;
    counts[1] = made;
    return out;
}
