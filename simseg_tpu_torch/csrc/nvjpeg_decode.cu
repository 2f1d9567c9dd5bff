// JPEG decoding on the card through nvJPEG (the CUDA toolkit's decoder),
// with a plain C interface for ctypes (simseg_tpu_torch/data/image_io.py).
//
// Replaces no TPU kernel: the JAX package decodes its eval images with PIL
// on the host (simseg_tpu/data/datasets.py:197-198). nvJPEG does the
// entropy decode on the host and the dequantisation and IDCT on the card,
// and writes the component planes as the file stores them (Y, Cb, Cr, the
// chroma planes at their subsampled size) into buffers the caller
// allocated on the card. The caller upsamples the chroma and converts to
// RGB with libjpeg's integer arithmetic, as PIL does: nvJPEG's own RGB
// output replicates subsampled chroma where libjpeg interpolates it, which
// moves edge pixels by tens of levels. One handle and one decode state
// serve the process, behind a mutex: nvJPEG's state is not thread-safe,
// and the loader decodes from several threads. Each decode ends with a
// synchronise of the caller's stream, so the caller may free its host
// bytes as soon as the call returns.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libnvjpeg_decode.so nvjpeg_decode.cu -lnvjpeg

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <mutex>

namespace {

std::mutex g_lock;
nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_state = nullptr;

// codes below kCudaBase are nvjpegStatus_t values; from it, CUDA errors
constexpr int kCudaBase = 1000;

int ensure_handle() {
  if (g_handle != nullptr) return NVJPEG_STATUS_SUCCESS;
  nvjpegStatus_t st = nvjpegCreateSimple(&g_handle);
  if (st != NVJPEG_STATUS_SUCCESS) {
    g_handle = nullptr;
    return st;
  }
  st = nvjpegJpegStateCreate(g_handle, &g_state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    nvjpegDestroy(g_handle);
    g_handle = nullptr;
    g_state = nullptr;
  }
  return st;
}

}  // namespace

extern "C" {

const char* nvjpeg_decode_error_string(int code) {
  if (code >= kCudaBase) return cudaGetErrorString(static_cast<cudaError_t>(code - kCudaBase));
  switch (code) {
    case NVJPEG_STATUS_SUCCESS: return "success";
    case NVJPEG_STATUS_NOT_INITIALIZED: return "nvJPEG: not initialized";
    case NVJPEG_STATUS_INVALID_PARAMETER: return "nvJPEG: invalid parameter";
    case NVJPEG_STATUS_BAD_JPEG: return "nvJPEG: bad JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "nvJPEG: JPEG not supported";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "nvJPEG: allocator failure";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "nvJPEG: execution failed";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "nvJPEG: architecture mismatch";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "nvJPEG: internal error";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
      return "nvJPEG: implementation not supported";
    default: return "nvJPEG: unknown status";
  }
}

// Component count, chroma subsampling (nvjpegChromaSubsampling_t) and each
// component's width and height (widths[4], heights[4]) of the JPEG in
// data[0, bytes).
int nvjpeg_image_info(const unsigned char* data, size_t bytes, int* components,
                      int* subsampling, int* widths, int* heights) {
  std::lock_guard<std::mutex> guard(g_lock);
  int st = ensure_handle();
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  nvjpegChromaSubsampling_t css;
  st = nvjpegGetImageInfo(g_handle, data, bytes, components, &css, widths,
                          heights);
  *subsampling = static_cast<int>(css);
  return st;
}

// Decodes the JPEG's components into planes[c] (row pitch pitches[c]
// bytes, uint8 on the card), components of them, on stream; returns when
// the decode has finished.
int nvjpeg_decode_planes(const unsigned char* data, size_t bytes,
                         unsigned char** planes, const int* pitches,
                         int components, void* stream) {
  std::lock_guard<std::mutex> guard(g_lock);
  int st = ensure_handle();
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  nvjpegImage_t image = {};
  for (int c = 0; c < components && c < NVJPEG_MAX_COMPONENT; ++c) {
    image.channel[c] = planes[c];
    image.pitch[c] = static_cast<size_t>(pitches[c]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  st = nvjpegDecode(g_handle, g_state, data, bytes, NVJPEG_OUTPUT_UNCHANGED,
                    &image, s);
  if (st != NVJPEG_STATUS_SUCCESS) return st;
  cudaError_t err = cudaStreamSynchronize(s);
  if (err != cudaSuccess) return kCudaBase + static_cast<int>(err);
  return NVJPEG_STATUS_SUCCESS;
}

}  // extern "C"
