/* C ABI for the pumiumtally_tpu_torch track-length tally (PyTorch, CUDA).
 *
 * The drop-in integration surface for a C/C++ Monte Carlo host (the role
 * OpenMC plays for the reference library): the same four entry points and
 * raw-pointer array contracts as the reference's PumiTally facade
 * (pumipic_particle_data_structure.h:20-47), hosted over an embedded
 * Python runtime that drives pumiumtally_tpu_torch.capi on the CUDA card
 * (libpumi_tally_c-<hash>.so, built from pumi_tally_c.cpp by
 * pumiumtally_tpu_torch.capi.build_bridge). The declarations are those of
 * the JAX package's native/include/pumi_tally.h, so a host compiled
 * against either header links against either library.
 *
 * All functions return 0 on success, -1 on error; pumi_tally_last_error()
 * returns a description of the most recent failure (thread-unsafe, like
 * errno).
 */
#ifndef PUMI_TALLY_H
#define PUMI_TALLY_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct pumi_tally pumi_tally_t;

/* Create a tally on a mesh file (.msh or .npz) with num_particles slots
 * and n_groups energy groups. Returns NULL on failure. */
pumi_tally_t* pumi_tally_create(const char* mesh_file,
                                int64_t num_particles,
                                int32_t n_groups);

/* Initial parent-element search; positions is [num_particles*3] doubles.
 * Nothing is tallied (reference cpp:209-219). */
int pumi_tally_initialize_particle_location(pumi_tally_t* t,
                                            double* positions,
                                            int64_t size);

/* Per advance event (reference cpp:221-264). In/out raw arrays:
 *   dests        [num_particles*3] double — in: destinations; out: final
 *                positions, clipped at domain/material boundaries
 *   flying       [num_particles] int8 — in: in-flight flags; out: zeroed
 *   weights      [num_particles] double
 *   groups       [num_particles] int32
 *   material_ids [num_particles] int32 — out: new material on region
 *                crossings, -1 on destination-reached/domain-exit
 */
int pumi_tally_move_to_next_location(pumi_tally_t* t,
                                     double* dests,
                                     int8_t* flying,
                                     double* weights,
                                     int32_t* groups,
                                     int32_t* material_ids,
                                     int64_t size);

/* Normalize + write VTK (reference cpp:296-302). */
int pumi_tally_write(pumi_tally_t* t, const char* filename);

/* Raw accumulated flux readback: out is [ntet * n_groups * 2] doubles.
 * Returns the element count written, or -1. */
int64_t pumi_tally_get_flux(pumi_tally_t* t, double* out, int64_t capacity);

void pumi_tally_destroy(pumi_tally_t* t);

const char* pumi_tally_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* PUMI_TALLY_H */
