// Fast Plumed-1 grid text I/O — the native path of edm_tpu_torch.utils.gridio
// (format contract: reference lib/grid.h:448-503
// writer / :712-835 reader; fixed 8-decimal rows, dim-0-fastest ordering,
// blank line when the fastest index resets, derivative sign flip on both
// write and read).
//
// Build: g++ -O2 -shared -fPIC -o _gridio.so gridio.cpp (native/__init__.py
// does it at first use; ctypes binding, no pybind11 dependency).  The
// Python writer in utils/gridio.py defines the format; this one must write
// the same bytes.

#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// values/derivs are flattened dim-0-fastest (Fortran order of the numpy
// array); header fields are the ON-FILE (deflated) values.
int edm_write_grid(const char* path,
                   int dim,
                   const long* nbins_file,   // deflated BIN values
                   const double* min_file,   // MIN values
                   const double* max_file,   // deflated MAX values
                   const int* pbc,
                   const double* dx,
                   const double* grid_min,   // actual grid min (row coords)
                   long total_points,        // actual stored points
                   const long* nbins_mem,    // actual per-dim point counts
                   const double* values,
                   const double* derivs,     // may be null
                   int has_derivs) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;

  fprintf(f, "#! FORCE %d\n", has_derivs ? 1 : 0);
  fprintf(f, "#! NVAR %d\n", dim);
  fprintf(f, "#! TYPE ");
  for (int d = 0; d < dim; d++) fprintf(f, "32 ");
  fprintf(f, "\n#! BIN ");
  for (int d = 0; d < dim; d++) fprintf(f, "%ld ", nbins_file[d]);
  fprintf(f, "\n#! MIN ");
  for (int d = 0; d < dim; d++) fprintf(f, "%.6g ", min_file[d]);
  fprintf(f, "\n#! MAX ");
  for (int d = 0; d < dim; d++) fprintf(f, "%.6g ", max_file[d]);
  fprintf(f, "\n#! PBC ");
  for (int d = 0; d < dim; d++) fprintf(f, "%d ", pbc[d]);
  fprintf(f, "\n");

  long idx[8] = {0};
  for (long i = 0; i < total_points; i++) {
    for (int d = 0; d < dim; d++)
      fprintf(f, "%.8f ", grid_min[d] + dx[d] * (double)idx[d]);
    fprintf(f, "%.8f ", values[i]);
    if (has_derivs)
      for (int d = 0; d < dim; d++)
        fprintf(f, "%.8f ", -derivs[i * dim + d]);
    fputc('\n', f);
    if (idx[0] == nbins_mem[0] - 1) fputc('\n', f);
    // increment dim-0-fastest multi-index
    for (int d = 0; d < dim; d++) {
      if (++idx[d] < nbins_mem[d]) break;
      idx[d] = 0;
    }
  }
  fclose(f);
  return 0;
}

// Reads only the data rows (header parsed in Python): skips `dim` leading
// coordinate columns per row, fills values[total] and derivs[total*dim]
// (sign-flipped). Returns number of points read, or -1 on error.
long edm_read_grid_data(const char* path,
                        int dim,
                        long total_points,
                        int has_derivs,
                        double* values,
                        double* derivs) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  // skip 7 header lines
  char line[4096];
  for (int i = 0; i < 7; i++)
    if (!fgets(line, sizeof line, f)) { fclose(f); return -1; }

  long n = 0;
  double tmp;
  while (n < total_points) {
    for (int d = 0; d < dim; d++)
      if (fscanf(f, "%lf", &tmp) != 1) { fclose(f); return n; }
    if (fscanf(f, "%lf", &values[n]) != 1) { fclose(f); return n; }
    if (has_derivs) {
      for (int d = 0; d < dim; d++) {
        if (fscanf(f, "%lf", &tmp) != 1) { fclose(f); return n; }
        derivs[n * dim + d] = -tmp;
      }
    }
    n++;
  }
  fclose(f);
  return n;
}

}  // extern "C"
