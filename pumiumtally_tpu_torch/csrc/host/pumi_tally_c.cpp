// C ABI host bridge: embeds CPython and forwards the four facade calls to
// pumiumtally_tpu_torch.capi with zero-copy memoryviews over the caller's
// raw pointers. This is the linkable library a C/C++ Monte Carlo host
// (OpenMC's role) uses in place of the reference's pimpl facade — same
// entry points, same array contracts (pumipic_particle_data_structure.h:
// 20-47). The tally runs on the CUDA card unless PUMI_TPU_PLATFORM=cpu.
//
// Build: pumiumtally_tpu_torch.capi.build_bridge() (g++ with the compile
// and link flags of the running interpreter's sysconfig).
//
// Order at start-up: the interpreter is initialised and capi imported
// (torch starts its threads at import), then this thread releases the GIL;
// CUDA initialises later, inside the first create().

#include <Python.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

#include "include/pumi_tally.h"

namespace {

std::string g_last_error;

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// Interpreter bootstrap: initialize once, import capi, then detach the
// init thread from the GIL (PyEval_SaveThread) so later calls from ANY
// host thread can take it via PyGILState_Ensure — without the detach, the
// thread that called Py_InitializeEx would hold the GIL forever and every
// other thread would deadlock in Ensure.
PyObject* g_capi = nullptr;
std::mutex g_init_mutex;

bool ensure_runtime() {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_capi) return true;
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    we_initialized = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* mod = PyImport_ImportModule("pumiumtally_tpu_torch.capi");
  if (!mod) {
    set_error_from_python();
    PyGILState_Release(gil);
    return false;
  }
  g_capi = mod;  // keep the reference
  PyGILState_Release(gil);
  if (we_initialized) {
    // Py_InitializeEx leaves this thread attached (GIL held, Release
    // above was a no-op for it); detach so other threads can Ensure.
    PyEval_SaveThread();
  }
  return true;
}

// Call capi.<fn>(*args); returns the result (new ref) or nullptr.
PyObject* capi_call(const char* fn, PyObject* args) {
  PyObject* f = PyObject_GetAttrString(g_capi, fn);
  if (!f) {
    set_error_from_python();
    Py_XDECREF(args);
    return nullptr;
  }
  PyObject* r = PyObject_CallObject(f, args);
  Py_DECREF(f);
  Py_XDECREF(args);
  if (!r) set_error_from_python();
  return r;
}

PyObject* mv_from(void* ptr, int64_t nbytes) {
  return PyMemoryView_FromMemory(
      static_cast<char*>(ptr), nbytes, PyBUF_WRITE);
}

}  // namespace

extern "C" {

struct pumi_tally {
  long handle;
  int64_t num_particles;
  int32_t n_groups;
};

pumi_tally_t* pumi_tally_create(const char* mesh_file, int64_t num_particles,
                                int32_t n_groups) {
  if (!ensure_runtime()) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = capi_call(
      "create",
      Py_BuildValue("(sLi)", mesh_file, (long long)num_particles,
                    (int)n_groups));
  pumi_tally_t* out = nullptr;
  if (r) {
    out = new pumi_tally{PyLong_AsLong(r), num_particles, n_groups};
    Py_DECREF(r);
  }
  PyGILState_Release(gil);
  return out;
}

int pumi_tally_initialize_particle_location(pumi_tally_t* t,
                                            double* positions,
                                            int64_t size) {
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = capi_call(
      "initialize_particle_location",
      Py_BuildValue("(lNL)", t->handle,
                    mv_from(positions, size * (int64_t)sizeof(double)),
                    (long long)size));
  PyGILState_Release(gil);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

int pumi_tally_move_to_next_location(pumi_tally_t* t, double* dests,
                                     int8_t* flying, double* weights,
                                     int32_t* groups, int32_t* material_ids,
                                     int64_t size) {
  const int64_t n = t->num_particles;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = capi_call(
      "move_to_next_location",
      Py_BuildValue(
          "(lNNNNNL)", t->handle,
          mv_from(dests, size * (int64_t)sizeof(double)),
          mv_from(flying, n * (int64_t)sizeof(int8_t)),
          mv_from(weights, n * (int64_t)sizeof(double)),
          mv_from(groups, n * (int64_t)sizeof(int32_t)),
          mv_from(material_ids, n * (int64_t)sizeof(int32_t)),
          (long long)size));
  PyGILState_Release(gil);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

int pumi_tally_write(pumi_tally_t* t, const char* filename) {
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r =
      capi_call("write", Py_BuildValue("(ls)", t->handle, filename));
  PyGILState_Release(gil);
  if (!r) return -1;
  Py_DECREF(r);
  return 0;
}

int64_t pumi_tally_get_flux(pumi_tally_t* t, double* out, int64_t capacity) {
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = capi_call(
      "get_flux",
      Py_BuildValue("(lNL)", t->handle,
                    mv_from(out, capacity * (int64_t)sizeof(double)),
                    (long long)capacity));
  int64_t n = -1;
  if (r) {
    n = PyLong_AsLongLong(r);
    Py_DECREF(r);
  }
  PyGILState_Release(gil);
  return n;
}

void pumi_tally_destroy(pumi_tally_t* t) {
  if (!t) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* r = capi_call("destroy", Py_BuildValue("(l)", t->handle));
  Py_XDECREF(r);
  PyGILState_Release(gil);
  delete t;
}

const char* pumi_tally_last_error(void) { return g_last_error.c_str(); }

}  // extern "C"
