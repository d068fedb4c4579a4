/* Fixture generator for the KLT framework test suite.
 *
 * This driver links against a scratch build of the reference CPU
 * implementation (FatimaSohailll/KLT-Feature-Tracker-Acceleration-GPUs,
 * src/V1) and dumps raw float32/int32 arrays that the Python tests use as
 * numerical oracles.  It only CALLS the reference's public/internal API
 * (klt.h, convolve.h, pyramid.h); no reference code is copied into this
 * repository.  See gen.sh for how the scratch build is produced.
 *
 * Fixtures produced (all little-endian raw arrays):
 *   smoothed_img0.f32      [240*320]  smoothed img0, sigma = 0.7
 *   gradx_img0.f32         [240*320]  x-gradient of smoothed img0, sigma = 1.0
 *   grady_img0.f32         [240*320]  y-gradient of smoothed img0, sigma = 1.0
 *   pyr1_img0.f32          [60*80]    pyramid level 1 (subsampling 4)
 *   pyr1_gradx_img0.f32    [60*80]    gradients of pyramid level 1
 *   pyr1_grady_img0.f32    [60*80]
 *   delta_smooth_s{S}.f32  [64*64]    impulse response of smoothing (kernel oracle)
 *   delta_gradx_s{S}.f32   [64*64]    impulse response of gradient-x
 *   delta_grady_s{S}.f32   [64*64]    impulse response of gradient-y
 *   select_img0.xyv        150 * (f32 x, f32 y, i32 val)  selection output
 *   track_0_1.xyv          150 * (f32 x, f32 y, i32 val)  after tracking img0->img1
 *   table_replace.ft       KLTFT1 binary table, 150 feat x 10 frames, replacement on
 *   table_affine.ft        KLTFT1 binary table, affineConsistencyCheck = 2
 *   table_lighting.ft      KLTFT1 binary table, lighting_insensitive = 1
 *   table_lighting_affine.ft  KLTFT1 binary table, lighting + affine = 2
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "pnmio.h"
#include "klt.h"
#include "klt_util.h"
#include "convolve.h"
#include "pyramid.h"

static const char *DATA = "/root/reference/data/images_provided";
static char OUT[512] = "fixtures";

static void dump_f32(const char *name, const float *p, long n)
{
  char path[1024];
  FILE *f;
  snprintf(path, sizeof path, "%s/%s", OUT, name);
  f = fopen(path, "wb");
  if (!f) { perror(path); exit(1); }
  fwrite(p, sizeof(float), n, f);
  fclose(f);
}

static void dump_featurelist(const char *name, KLT_FeatureList fl)
{
  char path[1024];
  FILE *f;
  int i;
  snprintf(path, sizeof path, "%s/%s", OUT, name);
  f = fopen(path, "wb");
  if (!f) { perror(path); exit(1); }
  for (i = 0; i < fl->nFeatures; i++) {
    float x = fl->feature[i]->x, y = fl->feature[i]->y;
    int v = fl->feature[i]->val;
    fwrite(&x, 4, 1, f);
    fwrite(&y, 4, 1, f);
    fwrite(&v, 4, 1, f);
  }
  fclose(f);
}

static unsigned char *read_frame(int idx, int *ncols, int *nrows)
{
  char path[1024];
  snprintf(path, sizeof path, "%s/img%d.pgm", DATA, idx);
  return pgmReadFile(path, NULL, ncols, nrows);
}

/* Impulse responses: feed a centered delta through the reference's
 * smoothing / gradient operators so the Python side can recover the
 * exact (truncated, normalized, f32) kernel taps. */
static void kernel_oracle(float sigma, const char *tag)
{
  int n = 64, c = 32;
  char name[256];
  _KLT_FloatImage delta = _KLTCreateFloatImage(n, n);
  _KLT_FloatImage sm = _KLTCreateFloatImage(n, n);
  _KLT_FloatImage gx = _KLTCreateFloatImage(n, n);
  _KLT_FloatImage gy = _KLTCreateFloatImage(n, n);
  memset(delta->data, 0, n * n * sizeof(float));
  delta->data[c * n + c] = 1.0f;

  _KLTComputeSmoothedImage(delta, sigma, sm);
  snprintf(name, sizeof name, "delta_smooth_s%s.f32", tag);
  dump_f32(name, sm->data, n * n);

  _KLTComputeGradients(delta, sigma, gx, gy);
  snprintf(name, sizeof name, "delta_gradx_s%s.f32", tag);
  dump_f32(name, gx->data, n * n);
  snprintf(name, sizeof name, "delta_grady_s%s.f32", tag);
  dump_f32(name, gy->data, n * n);

  _KLTFreeFloatImage(delta);
  _KLTFreeFloatImage(sm);
  _KLTFreeFloatImage(gx);
  _KLTFreeFloatImage(gy);
}

/* Run a 10-frame sequential tracking loop (mirrors the reference example3
 * semantics: result of tracking frame i stored at column i-1) with the
 * given context tweaks, and write the binary feature table. */
static void run_sequence(const char *table_name, int replace, int affine,
                         int lighting)
{
  KLT_TrackingContext tc = KLTCreateTrackingContext();
  KLT_FeatureList fl = KLTCreateFeatureList(150);
  KLT_FeatureTable ft = KLTCreateFeatureTable(10, 150);
  unsigned char *img1, *img2;
  int ncols, nrows, i;
  char path[1024];

  tc->sequentialMode = TRUE;
  tc->affineConsistencyCheck = affine;
  tc->lighting_insensitive = lighting;

  img1 = read_frame(0, &ncols, &nrows);
  KLTSelectGoodFeatures(tc, img1, ncols, nrows, fl);
  KLTStoreFeatureList(fl, ft, 0);
  img2 = (unsigned char *)malloc(ncols * nrows);

  for (i = 1; i < 10; i++) {
    unsigned char *frame = read_frame(i, &ncols, &nrows);
    memcpy(img2, frame, ncols * nrows);
    free(frame);
    KLTTrackFeatures(tc, img1, img2, ncols, nrows, fl);
    if (replace)
      KLTReplaceLostFeatures(tc, img2, ncols, nrows, fl);
    KLTStoreFeatureList(fl, ft, i - 1);
    memcpy(img1, img2, ncols * nrows);
  }

  snprintf(path, sizeof path, "%s/%s", OUT, table_name);
  KLTWriteFeatureTable(ft, path, NULL);

  KLTFreeFeatureTable(ft);
  KLTFreeFeatureList(fl);
  KLTFreeTrackingContext(tc);
  free(img1);
  free(img2);
}

int main(int argc, char **argv)
{
  unsigned char *img0, *img1u;
  int ncols, nrows, i;
  _KLT_FloatImage raw, sm, gx, gy;
  _KLT_Pyramid pyr, pgx, pgy;
  KLT_TrackingContext tc;
  KLT_FeatureList fl;

  if (argc > 1) snprintf(OUT, sizeof OUT, "%s", argv[1]);
  KLTSetVerbosity(0);

  img0 = read_frame(0, &ncols, &nrows);

  /* --- convolution / pyramid oracles on img0 --- */
  raw = _KLTCreateFloatImage(ncols, nrows);
  sm = _KLTCreateFloatImage(ncols, nrows);
  gx = _KLTCreateFloatImage(ncols, nrows);
  gy = _KLTCreateFloatImage(ncols, nrows);
  _KLTToFloatImage(img0, ncols, nrows, raw);
  _KLTComputeSmoothedImage(raw, 0.7f, sm);   /* smooth_sigma_fact * window */
  dump_f32("smoothed_img0.f32", sm->data, ncols * nrows);
  _KLTComputeGradients(sm, 1.0f, gx, gy);    /* grad_sigma default */
  dump_f32("gradx_img0.f32", gx->data, ncols * nrows);
  dump_f32("grady_img0.f32", gy->data, ncols * nrows);

  pyr = _KLTCreatePyramid(ncols, nrows, 4, 2);
  _KLTComputePyramid(sm, pyr, 0.9f);
  dump_f32("pyr1_img0.f32", pyr->img[1]->data,
           pyr->ncols[1] * pyr->nrows[1]);
  pgx = _KLTCreatePyramid(ncols, nrows, 4, 2);
  pgy = _KLTCreatePyramid(ncols, nrows, 4, 2);
  for (i = 0; i < 2; i++)
    _KLTComputeGradients(pyr->img[i], 1.0f, pgx->img[i], pgy->img[i]);
  dump_f32("pyr1_gradx_img0.f32", pgx->img[1]->data,
           pyr->ncols[1] * pyr->nrows[1]);
  dump_f32("pyr1_grady_img0.f32", pgy->img[1]->data,
           pyr->ncols[1] * pyr->nrows[1]);

  /* --- kernel impulse responses --- */
  kernel_oracle(0.7f, "0p7");
  kernel_oracle(1.0f, "1p0");
  kernel_oracle(3.6f, "3p6");

  /* --- selection + one tracking step --- */
  tc = KLTCreateTrackingContext();
  fl = KLTCreateFeatureList(150);
  KLTSelectGoodFeatures(tc, img0, ncols, nrows, fl);
  dump_featurelist("select_img0.xyv", fl);

  img1u = read_frame(1, &ncols, &nrows);
  KLTTrackFeatures(tc, img0, img1u, ncols, nrows, fl);
  dump_featurelist("track_0_1.xyv", fl);
  KLTFreeFeatureList(fl);
  KLTFreeTrackingContext(tc);

  /* --- behavioural variants over the 10-frame sequence --- */
  run_sequence("table_replace.ft", 1, -1, 0);
  run_sequence("table_affine.ft", 0, 2, 0);
  run_sequence("table_lighting.ft", 0, -1, 1);
  /* lighting-insensitive translation + affine check: the affine stage
   * itself has no lighting normalization in the reference */
  run_sequence("table_lighting_affine.ft", 0, 2, 1);

  printf("fixtures written to %s\n", OUT);
  return 0;
}
