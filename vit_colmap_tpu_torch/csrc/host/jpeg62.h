// The libjpeg 6.2 ABI (JPEG_LIB_VERSION 62, 8-bit samples) that
// jpeg_libjpeg.cc uses, declared here so that the build needs only the
// runtime libjpeg.so.62 and no jpeglib.h.  The two master structs are
// declared whole: libjpeg checks their size when they are created.  Private
// pointers are declared as void*; the layout is the same.
// tests/test_torch_native_io.py compiles a unit against a system jpeglib.h
// and holds sizeof and every offsetof below to it.

#ifndef VC_JPEG62_H_
#define VC_JPEG62_H_

#include <cstdio>

extern "C" {

typedef int boolean;
typedef unsigned int JDIMENSION;
typedef unsigned char JSAMPLE;
typedef JSAMPLE* JSAMPROW;
typedef JSAMPROW* JSAMPARRAY;
typedef JSAMPARRAY* JSAMPIMAGE;

#define JPEG_LIB_VERSION 62
#define JMSG_LENGTH_MAX 200
#define DCTSIZE 8

typedef enum {
  JCS_UNKNOWN,
  JCS_GRAYSCALE,
  JCS_RGB,
  JCS_YCbCr,
  JCS_CMYK,
  JCS_YCCK
} J_COLOR_SPACE;

typedef enum { JDCT_ISLOW, JDCT_IFAST, JDCT_FLOAT } J_DCT_METHOD;
typedef enum { JDITHER_NONE, JDITHER_ORDERED, JDITHER_FS } J_DITHER_MODE;

struct jpeg_common_struct;
typedef struct jpeg_common_struct* j_common_ptr;

struct jpeg_error_mgr {
  void (*error_exit)(j_common_ptr cinfo);
  void (*emit_message)(j_common_ptr cinfo, int msg_level);
  void (*output_message)(j_common_ptr cinfo);
  void (*format_message)(j_common_ptr cinfo, char* buffer);
  void (*reset_error_mgr)(j_common_ptr cinfo);
  int msg_code;
  union {
    int i[8];
    char s[80];
  } msg_parm;
  int trace_level;
  long num_warnings;
  const char* const* jpeg_message_table;
  int last_jpeg_message;
  const char* const* addon_message_table;
  int first_addon_message;
  int last_addon_message;
};

// One entry of comp_info (jpeglib.h's typedef of an unnamed struct; the
// same layout under a name).
struct jpeg_component_info {
  int component_id;
  int component_index;
  int h_samp_factor;
  int v_samp_factor;
  int quant_tbl_no;
  int dc_tbl_no;
  int ac_tbl_no;
  JDIMENSION width_in_blocks;
  JDIMENSION height_in_blocks;
  int DCT_scaled_size;
  JDIMENSION downsampled_width;
  JDIMENSION downsampled_height;
  boolean component_needed;
  int MCU_width;
  int MCU_height;
  int MCU_blocks;
  int MCU_sample_width;
  int last_col_width;
  int last_row_height;
  void* quant_table;
  void* dct_table;
};

#define VC_JPEG_COMMON_FIELDS \
  struct jpeg_error_mgr* err; \
  void* mem;                  \
  void* progress;             \
  void* client_data;          \
  boolean is_decompressor;    \
  int global_state

struct jpeg_common_struct {
  VC_JPEG_COMMON_FIELDS;
};

struct jpeg_compress_struct {
  VC_JPEG_COMMON_FIELDS;
  void* dest;
  JDIMENSION image_width;
  JDIMENSION image_height;
  int input_components;
  J_COLOR_SPACE in_color_space;
  double input_gamma;
  int data_precision;
  int num_components;
  J_COLOR_SPACE jpeg_color_space;
  void* comp_info;
  void* quant_tbl_ptrs[4];
  void* dc_huff_tbl_ptrs[4];
  void* ac_huff_tbl_ptrs[4];
  unsigned char arith_dc_L[16];
  unsigned char arith_dc_U[16];
  unsigned char arith_ac_K[16];
  int num_scans;
  const void* scan_info;
  boolean raw_data_in;
  boolean arith_code;
  boolean optimize_coding;
  boolean CCIR601_sampling;
  int smoothing_factor;
  J_DCT_METHOD dct_method;
  unsigned int restart_interval;
  int restart_in_rows;
  boolean write_JFIF_header;
  unsigned char JFIF_major_version;
  unsigned char JFIF_minor_version;
  unsigned char density_unit;
  unsigned short X_density;
  unsigned short Y_density;
  boolean write_Adobe_marker;
  JDIMENSION next_scanline;
  boolean progressive_mode;
  int max_h_samp_factor;
  int max_v_samp_factor;
  JDIMENSION total_iMCU_rows;
  int comps_in_scan;
  void* cur_comp_info[4];
  JDIMENSION MCUs_per_row;
  JDIMENSION MCU_rows_in_scan;
  int blocks_in_MCU;
  int MCU_membership[10];
  int Ss, Se, Ah, Al;
  void* master;
  void* main;
  void* prep;
  void* coef;
  void* marker;
  void* cconvert;
  void* downsample;
  void* fdct;
  void* entropy;
  void* script_space;
  int script_space_size;
};

struct jpeg_decompress_struct {
  VC_JPEG_COMMON_FIELDS;
  void* src;
  JDIMENSION image_width;
  JDIMENSION image_height;
  int num_components;
  J_COLOR_SPACE jpeg_color_space;
  J_COLOR_SPACE out_color_space;
  unsigned int scale_num, scale_denom;
  double output_gamma;
  boolean buffered_image;
  boolean raw_data_out;
  J_DCT_METHOD dct_method;
  boolean do_fancy_upsampling;
  boolean do_block_smoothing;
  boolean quantize_colors;
  J_DITHER_MODE dither_mode;
  boolean two_pass_quantize;
  int desired_number_of_colors;
  boolean enable_1pass_quant;
  boolean enable_external_quant;
  boolean enable_2pass_quant;
  JDIMENSION output_width;
  JDIMENSION output_height;
  int out_color_components;
  int output_components;
  int rec_outbuf_height;
  int actual_number_of_colors;
  JSAMPARRAY colormap;
  JDIMENSION output_scanline;
  int input_scan_number;
  JDIMENSION input_iMCU_row;
  int output_scan_number;
  JDIMENSION output_iMCU_row;
  int (*coef_bits)[64];
  void* quant_tbl_ptrs[4];
  void* dc_huff_tbl_ptrs[4];
  void* ac_huff_tbl_ptrs[4];
  int data_precision;
  void* comp_info;
  boolean progressive_mode;
  boolean arith_code;
  unsigned char arith_dc_L[16];
  unsigned char arith_dc_U[16];
  unsigned char arith_ac_K[16];
  unsigned int restart_interval;
  boolean saw_JFIF_marker;
  unsigned char JFIF_major_version;
  unsigned char JFIF_minor_version;
  unsigned char density_unit;
  unsigned short X_density;
  unsigned short Y_density;
  boolean saw_Adobe_marker;
  unsigned char Adobe_transform;
  boolean CCIR601_sampling;
  void* marker_list;
  int max_h_samp_factor;
  int max_v_samp_factor;
  int min_DCT_scaled_size;
  JDIMENSION total_iMCU_rows;
  JSAMPLE* sample_range_limit;
  int comps_in_scan;
  void* cur_comp_info[4];
  JDIMENSION MCUs_per_row;
  JDIMENSION MCU_rows_in_scan;
  int blocks_in_MCU;
  int MCU_membership[10];
  int Ss, Se, Ah, Al;
  int unread_marker;
  void* master;
  void* main;
  void* coef;
  void* post;
  void* inputctl;
  void* marker;
  void* entropy;
  void* idct;
  void* upsample;
  void* cconvert;
  void* cquantize;
};

typedef struct jpeg_compress_struct* j_compress_ptr;
typedef struct jpeg_decompress_struct* j_decompress_ptr;

struct jpeg_error_mgr* jpeg_std_error(struct jpeg_error_mgr* err);
void jpeg_CreateCompress(j_compress_ptr cinfo, int version, size_t structsize);
void jpeg_CreateDecompress(j_decompress_ptr cinfo, int version,
                           size_t structsize);
void jpeg_destroy_compress(j_compress_ptr cinfo);
void jpeg_destroy_decompress(j_decompress_ptr cinfo);
void jpeg_stdio_dest(j_compress_ptr cinfo, FILE* outfile);
void jpeg_stdio_src(j_decompress_ptr cinfo, FILE* infile);
void jpeg_set_defaults(j_compress_ptr cinfo);
void jpeg_set_quality(j_compress_ptr cinfo, int quality,
                      boolean force_baseline);
void jpeg_start_compress(j_compress_ptr cinfo, boolean write_all_tables);
JDIMENSION jpeg_write_scanlines(j_compress_ptr cinfo, JSAMPARRAY scanlines,
                                JDIMENSION num_lines);
void jpeg_finish_compress(j_compress_ptr cinfo);
int jpeg_read_header(j_decompress_ptr cinfo, boolean require_image);
boolean jpeg_start_decompress(j_decompress_ptr cinfo);
JDIMENSION jpeg_read_scanlines(j_decompress_ptr cinfo, JSAMPARRAY scanlines,
                               JDIMENSION max_lines);
JDIMENSION jpeg_read_raw_data(j_decompress_ptr cinfo, JSAMPIMAGE data,
                              JDIMENSION max_lines);
boolean jpeg_finish_decompress(j_decompress_ptr cinfo);

}  // extern "C"

#endif  // VC_JPEG62_H_
