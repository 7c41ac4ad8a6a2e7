/* Transcode a Huffman-coded JPEG into an arithmetic-coded one with the same
 * quantized coefficients, so both decode to the same pixels.
 *
 *     gcc -O2 -o jpeg_arith_twin tools/jpeg_arith_twin.c -ljpeg
 *     jpeg_arith_twin IN OUT [progressive] [restart N] [dac L U K]
 *
 * `progressive` writes libjpeg's simple progression (SOF10), else one
 * sequential scan per the source (SOF9). `restart N` puts a restart marker
 * every N MCUs (jpeg_copy_critical_parameters drops the source's interval,
 * so it is set again here). `dac L U K` writes those conditioning values for
 * every DC (L, U) and AC (Kx) table instead of the defaults 0, 1, 5.
 * The colour space is the source's; libjpeg writes the JFIF or Adobe marker
 * that names it.
 *
 * tools/make_jpeg_fixtures.py builds and runs this against the system
 * libjpeg (whose encoder writes arithmetic coding); the port's decoder never
 * links it.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

int main(int argc, char **argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s IN OUT [progressive] [restart N] [dac L U K]\n",
            argv[0]);
    return 2;
  }
  int progressive = 0, restart = 0, dac = 0, L = 0, U = 1, K = 5;
  for (int i = 3; i < argc; i++) {
    if (!strcmp(argv[i], "progressive")) {
      progressive = 1;
    } else if (!strcmp(argv[i], "restart") && i + 1 < argc) {
      restart = atoi(argv[++i]);
    } else if (!strcmp(argv[i], "dac") && i + 3 < argc) {
      dac = 1;
      L = atoi(argv[++i]);
      U = atoi(argv[++i]);
      K = atoi(argv[++i]);
    } else {
      fprintf(stderr, "bad argument %s\n", argv[i]);
      return 2;
    }
  }
  FILE *in = fopen(argv[1], "rb");
  if (!in) {
    perror(argv[1]);
    return 1;
  }
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct jpeg_error_mgr jerr_src, jerr_dst;
  src.err = jpeg_std_error(&jerr_src);
  dst.err = jpeg_std_error(&jerr_dst);
  jpeg_create_decompress(&src);
  jpeg_create_compress(&dst);
  jpeg_stdio_src(&src, in);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&src);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = TRUE;
  dst.optimize_coding = FALSE;
  dst.restart_interval = (unsigned)restart;
  if (dac) {
    for (int t = 0; t < NUM_ARITH_TBLS; t++) {
      dst.arith_dc_L[t] = (UINT8)L;
      dst.arith_dc_U[t] = (UINT8)U;
      dst.arith_ac_K[t] = (UINT8)K;
    }
  }
  if (progressive) jpeg_simple_progression(&dst);
  FILE *out = fopen(argv[2], "wb");
  if (!out) {
    perror(argv[2]);
    return 1;
  }
  jpeg_stdio_dest(&dst, out);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  fclose(in);
  fclose(out);
  return 0;
}
