// The bridge import of the port's C library.
//
// The library is capi/cuvs_tpu_c.cpp, compiled unchanged with
// -DPyImport_ImportModule=cuvs_tpu_torch_import: its one import, of the
// bridge module "cuvs_tpu.capi_bridge", lands here and is answered with the
// port's bridge, cuvs_tpu_torch.capi_bridge. Any other name passes through.
// This file is compiled without that macro.
#include <Python.h>

#include <cstring>

extern "C" PyObject* cuvs_tpu_torch_import(const char* name) {
  if (std::strcmp(name, "cuvs_tpu.capi_bridge") == 0) name = "cuvs_tpu_torch.capi_bridge";
  return PyImport_ImportModule(name);
}
