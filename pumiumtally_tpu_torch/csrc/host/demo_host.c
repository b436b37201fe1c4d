/* Minimal C host driving pumiumtally_tpu_torch through the C ABI — the
 * integration smoke test for the OpenMC-shaped consumer. Usage:
 *   demo_host <mesh.msh|mesh.npz> <out.vtu>
 * Prints "FLUX_SUM <value>" and "OK" on success. */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "include/pumi_tally.h"

#define N 16

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s <mesh> <out.vtu>\n", argv[0]);
    return 2;
  }
  pumi_tally_t* t = pumi_tally_create(argv[1], N, 2);
  if (!t) {
    fprintf(stderr, "create failed: %s\n", pumi_tally_last_error());
    return 1;
  }

  double pos[N * 3];
  for (int i = 0; i < N; ++i) {
    pos[i * 3 + 0] = 0.2 + 0.6 * (i / (double)N);
    pos[i * 3 + 1] = 0.5;
    pos[i * 3 + 2] = 0.5;
  }
  if (pumi_tally_initialize_particle_location(t, pos, N * 3) != 0) {
    fprintf(stderr, "init failed: %s\n", pumi_tally_last_error());
    return 1;
  }

  double dests[N * 3];
  int8_t flying[N];
  double weights[N];
  int32_t groups[N];
  int32_t mats[N];
  for (int i = 0; i < N; ++i) {
    dests[i * 3 + 0] = pos[i * 3 + 0] + 2.0; /* exits the unit box */
    dests[i * 3 + 1] = 0.5;
    dests[i * 3 + 2] = 0.5;
    flying[i] = 1;
    weights[i] = 1.0;
    groups[i] = i % 2;
    mats[i] = -1;
  }
  if (pumi_tally_move_to_next_location(t, dests, flying, weights, groups,
                                       mats, N * 3) != 0) {
    fprintf(stderr, "move failed: %s\n", pumi_tally_last_error());
    return 1;
  }
  for (int i = 0; i < N; ++i) {
    if (flying[i] != 0) {
      fprintf(stderr, "flying not reset at %d\n", i);
      return 1;
    }
    /* Domain exit: final x clipped to the boundary, material -1. */
    if (dests[i * 3 + 0] > 1.0 + 1e-5) {
      fprintf(stderr, "dest %d not clipped: %f\n", i, dests[i * 3]);
      return 1;
    }
  }

  double* flux = (double*)malloc(sizeof(double) * 1000000);
  int64_t nf = pumi_tally_get_flux(t, flux, 1000000);
  if (nf < 0) {
    fprintf(stderr, "get_flux failed: %s\n", pumi_tally_last_error());
    return 1;
  }
  double sum = 0.0;
  for (int64_t i = 0; i < nf; i += 2) sum += flux[i]; /* slot 0 of each */
  printf("FLUX_SUM %.9f\n", sum);
  free(flux);

  if (pumi_tally_write(t, argv[2]) != 0) {
    fprintf(stderr, "write failed: %s\n", pumi_tally_last_error());
    return 1;
  }
  pumi_tally_destroy(t);
  printf("OK\n");
  return 0;
}
