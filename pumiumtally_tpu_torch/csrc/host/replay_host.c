/* Replay host: drives the C ABI with a recorded run, for tests that hold
 * the C path against the in-process facade. Usage:
 *
 *   replay_host <mesh> <dir> <num_particles> <moves> <groups> <flux_len>
 *
 * Reads from <dir>:
 *   pos.bin      [num_particles*3] double: the initial positions;
 *   move_<m>.bin for m = 1..moves: the move's destinations
 *                [num_particles*3] double, flying [num_particles] int8,
 *                weights [num_particles] double, groups [num_particles]
 *                int32 and material ids [num_particles] int32, in turn.
 * Calls create, initialize_particle_location and each move in order, then
 * get_flux and write. Writes into <dir>:
 *   out_<m>.bin  the move's write-backs: destinations, flying and
 *                material ids, laid out as in move_<m>.bin;
 *   flux.bin     [flux_len] double, the raw flux;
 *   flux.vtu     the normalized tally.
 * Prints each call's seconds on CLOCK_MONOTONIC ("CREATE_S", "INIT_S",
 * "MOVE_S <m>", "FLUX_S", "WRITE_S"), then "OK". Exit 0 on success. */
#define _POSIX_C_SOURCE 199309L
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "include/pumi_tally.h"

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

static int read_file(const char* path, void* buf, size_t nbytes) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    fprintf(stderr, "cannot open %s\n", path);
    return -1;
  }
  size_t got = fread(buf, 1, nbytes, f);
  fclose(f);
  if (got != nbytes) {
    fprintf(stderr, "%s: read %zu of %zu bytes\n", path, got, nbytes);
    return -1;
  }
  return 0;
}

static int write_parts(const char* path, const void* const* parts,
                       const size_t* sizes, int count) {
  FILE* f = fopen(path, "wb");
  if (!f) {
    fprintf(stderr, "cannot create %s\n", path);
    return -1;
  }
  for (int i = 0; i < count; ++i) {
    if (fwrite(parts[i], 1, sizes[i], f) != sizes[i]) {
      fclose(f);
      fprintf(stderr, "short write to %s\n", path);
      return -1;
    }
  }
  return fclose(f) == 0 ? 0 : -1;
}

int main(int argc, char** argv) {
  if (argc < 7) {
    fprintf(stderr,
            "usage: %s <mesh> <dir> <num_particles> <moves> <groups> "
            "<flux_len>\n",
            argv[0]);
    return 2;
  }
  const char* mesh = argv[1];
  const char* dir = argv[2];
  const int64_t n = atoll(argv[3]);
  const int moves = atoi(argv[4]);
  const int32_t groups_n = (int32_t)atoi(argv[5]);
  const int64_t flux_len = atoll(argv[6]);
  char path[4096];

  double* pos = malloc(sizeof(double) * 3 * n);
  double* dests = malloc(sizeof(double) * 3 * n);
  int8_t* flying = malloc((size_t)n);
  double* weights = malloc(sizeof(double) * n);
  int32_t* groups = malloc(sizeof(int32_t) * n);
  int32_t* mats = malloc(sizeof(int32_t) * n);
  double* flux = malloc(sizeof(double) * flux_len);
  if (!pos || !dests || !flying || !weights || !groups || !mats || !flux) {
    fprintf(stderr, "out of host memory\n");
    return 1;
  }
  snprintf(path, sizeof path, "%s/pos.bin", dir);
  if (read_file(path, pos, sizeof(double) * 3 * n) != 0) return 1;

  double t0 = now_s();
  pumi_tally_t* t = pumi_tally_create(mesh, n, groups_n);
  if (!t) {
    fprintf(stderr, "create failed: %s\n", pumi_tally_last_error());
    return 1;
  }
  printf("CREATE_S %.9f\n", now_s() - t0);

  t0 = now_s();
  if (pumi_tally_initialize_particle_location(t, pos, 3 * n) != 0) {
    fprintf(stderr, "init failed: %s\n", pumi_tally_last_error());
    return 1;
  }
  printf("INIT_S %.9f\n", now_s() - t0);

  for (int m = 1; m <= moves; ++m) {
    FILE* f;
    snprintf(path, sizeof path, "%s/move_%d.bin", dir, m);
    f = fopen(path, "rb");
    if (!f) {
      fprintf(stderr, "cannot open %s\n", path);
      return 1;
    }
    int ok = fread(dests, sizeof(double), 3 * n, f) == (size_t)(3 * n) &&
             fread(flying, 1, n, f) == (size_t)n &&
             fread(weights, sizeof(double), n, f) == (size_t)n &&
             fread(groups, sizeof(int32_t), n, f) == (size_t)n &&
             fread(mats, sizeof(int32_t), n, f) == (size_t)n;
    fclose(f);
    if (!ok) {
      fprintf(stderr, "%s is short\n", path);
      return 1;
    }
    t0 = now_s();
    if (pumi_tally_move_to_next_location(t, dests, flying, weights, groups,
                                         mats, 3 * n) != 0) {
      fprintf(stderr, "move %d failed: %s\n", m, pumi_tally_last_error());
      return 1;
    }
    printf("MOVE_S %d %.9f\n", m, now_s() - t0);
    fflush(stdout);
    const void* parts[3] = {dests, flying, mats};
    const size_t sizes[3] = {sizeof(double) * 3 * n, (size_t)n,
                             sizeof(int32_t) * n};
    snprintf(path, sizeof path, "%s/out_%d.bin", dir, m);
    if (write_parts(path, parts, sizes, 3) != 0) return 1;
  }

  t0 = now_s();
  int64_t got = pumi_tally_get_flux(t, flux, flux_len);
  if (got != flux_len) {
    fprintf(stderr, "get_flux returned %lld of %lld: %s\n", (long long)got,
            (long long)flux_len, pumi_tally_last_error());
    return 1;
  }
  printf("FLUX_S %.9f\n", now_s() - t0);
  {
    const void* parts[1] = {flux};
    const size_t sizes[1] = {sizeof(double) * flux_len};
    snprintf(path, sizeof path, "%s/flux.bin", dir);
    if (write_parts(path, parts, sizes, 1) != 0) return 1;
  }

  snprintf(path, sizeof path, "%s/flux.vtu", dir);
  t0 = now_s();
  if (pumi_tally_write(t, path) != 0) {
    fprintf(stderr, "write failed: %s\n", pumi_tally_last_error());
    return 1;
  }
  printf("WRITE_S %.9f\n", now_s() - t0);
  pumi_tally_destroy(t);
  free(pos);
  free(dests);
  free(flying);
  free(weights);
  free(groups);
  free(mats);
  free(flux);
  printf("OK\n");
  return 0;
}
