/* Batch object-materialization primitives for the scheduler hot path.
 *
 * The TPU kernel plans 50K placements in ~0.2s of device time; turning the
 * winning node indices into Allocation objects was ~2.5x that in pure
 * Python (one dict merge + dataclass clone per alloc).  These loops do the
 * same work through the CPython C API: clone a template __dict__, rebind
 * the per-alloc fields, and bucket the result by node — semantics
 * identical to the Python fallbacks in tpu/batch_sched.py (_materialize)
 * and scheduler/reconcile.py (_compute_placements), which remain the
 * behavioral reference and the path used when no C toolchain is present.
 *
 * Reference parity note: the reference reaches the same end state with Go
 * struct literals (generic_sched.go:426-566); this file exists for the
 * same reason its scheduler avoids reflection — allocation-plan assembly
 * is on the critical path of every evaluation.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

static PyObject *s_id, *s_name, *s_node_id, *s_node_name, *s_task_states,
    *s_desired_transition, *s_preempted_allocations, *s_dict;
static PyObject *empty_tuple;

/* obj = cls.__new__(cls); obj.__dict__ = d  (steals nothing; returns new ref) */
static PyObject *
instance_with_dict(PyTypeObject *cls, PyObject *d)
{
    PyObject *obj = cls->tp_new(cls, empty_tuple, NULL);
    if (obj == NULL)
        return NULL;
    if (PyObject_SetAttr(obj, s_dict, d) < 0) {
        Py_DECREF(obj);
        return NULL;
    }
    return obj;
}

/* materialize(cls, tmpl, ids, place, node_idx, node_ids, node_names,
 *             shared_dt, out) -> None
 *
 * tmpl      dict shared by every alloc, or a per-alloc list of dicts
 * ids       list[str]   alloc ids (len A)
 * place     list        placement descriptors; .name read per item (len A)
 * node_idx  list[int]   chosen node index per alloc (len A, all valid)
 * node_ids  list[str]   node id per node index
 * node_names list[str]  node name per node index
 * shared_dt object      the plan-wide DesiredTransition sentinel
 * out       dict        node_id -> list[alloc], appended in order
 */
static PyObject *
materialize(PyObject *self, PyObject *args)
{
    PyObject *cls, *tmpl, *ids, *place, *node_idx, *node_ids, *node_names,
        *shared_dt, *out;
    if (!PyArg_ParseTuple(args, "OOOOOOOOO", &cls, &tmpl, &ids, &place,
                          &node_idx, &node_ids, &node_names, &shared_dt,
                          &out))
        return NULL;
    if (!PyType_Check(cls) || !PyList_Check(ids) || !PyList_Check(place) ||
        !PyList_Check(node_idx) || !PyList_Check(node_ids) ||
        !PyList_Check(node_names) || !PyDict_Check(out)) {
        PyErr_SetString(PyExc_TypeError, "materialize: bad argument types");
        return NULL;
    }
    Py_ssize_t A = PyList_GET_SIZE(ids);
    Py_ssize_t N = PyList_GET_SIZE(node_ids);
    if (PyList_GET_SIZE(place) != A || PyList_GET_SIZE(node_idx) != A ||
        PyList_GET_SIZE(node_names) != N) {
        PyErr_SetString(PyExc_ValueError, "materialize: length mismatch");
        return NULL;
    }
    int tmpl_per_alloc = PyList_Check(tmpl);
    if (tmpl_per_alloc && PyList_GET_SIZE(tmpl) != A) {
        PyErr_SetString(PyExc_ValueError, "materialize: template length");
        return NULL;
    }
    if (!tmpl_per_alloc && !PyDict_Check(tmpl)) {
        PyErr_SetString(PyExc_TypeError, "materialize: template type");
        return NULL;
    }

    for (Py_ssize_t i = 0; i < A; i++) {
        PyObject *t =
            tmpl_per_alloc ? PyList_GET_ITEM(tmpl, i) : tmpl;
        Py_ssize_t ni = PyLong_AsSsize_t(PyList_GET_ITEM(node_idx, i));
        if (ni < 0 || ni >= N) {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_IndexError,
                                "materialize: node index out of range");
            return NULL;
        }
        PyObject *nid = PyList_GET_ITEM(node_ids, ni);

        PyObject *d = PyDict_Copy(t);
        if (d == NULL)
            return NULL;
        PyObject *nm = PyObject_GetAttr(PyList_GET_ITEM(place, i), s_name);
        if (nm == NULL) {
            Py_DECREF(d);
            return NULL;
        }
        PyObject *ts = PyDict_New();
        PyObject *pa = PyList_New(0);
        if (ts == NULL || pa == NULL ||
            PyDict_SetItem(d, s_id, PyList_GET_ITEM(ids, i)) < 0 ||
            PyDict_SetItem(d, s_name, nm) < 0 ||
            PyDict_SetItem(d, s_node_id, nid) < 0 ||
            PyDict_SetItem(d, s_node_name, PyList_GET_ITEM(node_names, ni)) < 0 ||
            PyDict_SetItem(d, s_task_states, ts) < 0 ||
            PyDict_SetItem(d, s_desired_transition, shared_dt) < 0 ||
            PyDict_SetItem(d, s_preempted_allocations, pa) < 0) {
            Py_XDECREF(ts);
            Py_XDECREF(pa);
            Py_DECREF(nm);
            Py_DECREF(d);
            return NULL;
        }
        Py_DECREF(ts);
        Py_DECREF(pa);
        Py_DECREF(nm);

        PyObject *obj = instance_with_dict((PyTypeObject *)cls, d);
        Py_DECREF(d);
        if (obj == NULL)
            return NULL;

        PyObject *bucket = PyDict_GetItemWithError(out, nid);
        if (bucket == NULL) {
            if (PyErr_Occurred()) {
                Py_DECREF(obj);
                return NULL;
            }
            bucket = PyList_New(0);
            if (bucket == NULL || PyDict_SetItem(out, nid, bucket) < 0) {
                Py_XDECREF(bucket);
                Py_DECREF(obj);
                return NULL;
            }
            Py_DECREF(bucket); /* out holds it; borrow below */
        }
        if (PyList_Append(bucket, obj) < 0) {
            Py_DECREF(obj);
            return NULL;
        }
        Py_DECREF(obj);
    }
    Py_RETURN_NONE;
}

/* clone_named(cls, tmpl, names) -> list
 * One instance per name: __dict__ = dict(tmpl, name=name). */
static PyObject *
clone_named(PyObject *self, PyObject *args)
{
    PyObject *cls, *tmpl, *names;
    if (!PyArg_ParseTuple(args, "OOO", &cls, &tmpl, &names))
        return NULL;
    if (!PyType_Check(cls) || !PyDict_Check(tmpl) || !PyList_Check(names)) {
        PyErr_SetString(PyExc_TypeError, "clone_named: bad argument types");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(names);
    PyObject *out = PyList_New(n);
    if (out == NULL)
        return NULL;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *d = PyDict_Copy(tmpl);
        if (d == NULL)
            goto fail;
        if (PyDict_SetItem(d, s_name, PyList_GET_ITEM(names, i)) < 0) {
            Py_DECREF(d);
            goto fail;
        }
        PyObject *obj = instance_with_dict((PyTypeObject *)cls, d);
        Py_DECREF(d);
        if (obj == NULL)
            goto fail;
        PyList_SET_ITEM(out, i, obj);
    }
    return out;
fail:
    Py_DECREF(out);
    return NULL;
}

/* uuid4_batch(n) -> list[str]  (RFC-4122 v4 from one urandom read) */
static PyObject *
uuid4_batch(PyObject *self, PyObject *args)
{
    Py_ssize_t n;
    if (!PyArg_ParseTuple(args, "n", &n))
        return NULL;
    if (n < 0) {
        PyErr_SetString(PyExc_ValueError, "uuid4_batch: negative count");
        return NULL;
    }
    PyObject *os_mod = PyImport_ImportModule("os");
    if (os_mod == NULL)
        return NULL;
    PyObject *raw = PyObject_CallMethod(os_mod, "urandom", "n", 16 * n);
    Py_DECREF(os_mod);
    if (raw == NULL)
        return NULL;
    const unsigned char *b = (const unsigned char *)PyBytes_AS_STRING(raw);
    PyObject *out = PyList_New(n);
    if (out == NULL) {
        Py_DECREF(raw);
        return NULL;
    }
    static const char hexd[] = "0123456789abcdef";
    /* groups of bytes: 4-2-2-2-6 with dashes between */
    static const int dash_after[16] = {0, 0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0,
                                       0, 0, 0, 0};
    for (Py_ssize_t i = 0; i < n; i++) {
        unsigned char u[16];
        memcpy(u, b + 16 * i, 16);
        u[6] = (unsigned char)((u[6] & 0x0f) | 0x40); /* version 4 */
        u[8] = (unsigned char)((u[8] & 0x3f) | 0x80); /* RFC variant */
        char s[36];
        int p = 0;
        for (int j = 0; j < 16; j++) {
            s[p++] = hexd[u[j] >> 4];
            s[p++] = hexd[u[j] & 0x0f];
            if (dash_after[j])
                s[p++] = '-';
        }
        PyObject *str = PyUnicode_FromStringAndSize(s, 36);
        if (str == NULL) {
            Py_DECREF(raw);
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, i, str);
    }
    Py_DECREF(raw);
    return out;
}

static PyMethodDef methods[] = {
    {"materialize", materialize, METH_VARARGS,
     "Batch-clone plan allocations from a template dict."},
    {"clone_named", clone_named, METH_VARARGS,
     "Batch-clone placement descriptors varying only in .name."},
    {"uuid4_batch", uuid4_batch, METH_VARARGS,
     "Generate n uuid4 strings from one urandom read."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastobj",
    "C batch-materialization tier for the scheduler hot path.", -1, methods,
};

PyMODINIT_FUNC
PyInit__fastobj(void)
{
#define INTERN(var, text)                                                    \
    do {                                                                     \
        var = PyUnicode_InternFromString(text);                              \
        if (var == NULL)                                                     \
            return NULL;                                                     \
    } while (0)
    INTERN(s_id, "id");
    INTERN(s_name, "name");
    INTERN(s_node_id, "node_id");
    INTERN(s_node_name, "node_name");
    INTERN(s_task_states, "task_states");
    INTERN(s_desired_transition, "desired_transition");
    INTERN(s_preempted_allocations, "preempted_allocations");
    INTERN(s_dict, "__dict__");
#undef INTERN
    empty_tuple = PyTuple_New(0);
    if (empty_tuple == NULL)
        return NULL;
    return PyModule_Create(&moduledef);
}
