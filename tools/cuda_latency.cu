// Dependent-operation latencies on one CUDA card, in cycles (clock64):
// f64 add and multiply, f32 add, independent f64 adds (throughput), a
// shared-memory load chain, a shuffle chain, a store + barrier + load
// round with 1, 2 and 4 warps, and the same with __syncwarp. The chains
// of the band kernels (csrc/band_kernels.cu) are sums of these.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false \
//        -o /tmp/cuda_latency tools/cuda_latency.cu && /tmp/cuda_latency
#include <cstdio>
#include <cuda_runtime.h>
__global__ void dadd_chain(double* out, long long* cyc, double a, double b, int n) {
    double x = a;
    long long t0 = clock64();
    for (int i = 0; i < n; ++i) { x = x + b; x = x - a; x = x + b; x = x - a; }
    long long t1 = clock64();
    out[threadIdx.x] = x; if (threadIdx.x == 0) cyc[0] = t1 - t0;
}
__global__ void dmul_chain(double* out, long long* cyc, double a, double b, int n) {
    double x = a;
    long long t0 = clock64();
    for (int i = 0; i < n; ++i) { x = x * b; x = x * a; x = x * b; x = x * a; }
    long long t1 = clock64();
    out[threadIdx.x] = x; if (threadIdx.x == 0) cyc[0] = t1 - t0;
}
__global__ void fadd_chain(double* out, long long* cyc, double a, double b, int n) {
    float x = a, fb = b, fa = a;
    long long t0 = clock64();
    for (int i = 0; i < n; ++i) { x = x + fb; x = x - fa; x = x + fb; x = x - fa; }
    long long t1 = clock64();
    out[threadIdx.x] = x; if (threadIdx.x == 0) cyc[0] = t1 - t0;
}
__global__ void dadd_thru(double* out, long long* cyc, double a, double b, int n) {
    double x0 = a, x1 = a + 1, x2 = a + 2, x3 = a + 3, x4 = a + 4, x5 = a + 5, x6 = a + 6, x7 = a + 7;
    long long t0 = clock64();
    for (int i = 0; i < n; ++i) { x0 += b; x1 += b; x2 += b; x3 += b; x4 += b; x5 += b; x6 += b; x7 += b; }
    long long t1 = clock64();
    out[threadIdx.x] = x0 + x1 + x2 + x3 + x4 + x5 + x6 + x7; if (threadIdx.x == 0) cyc[0] = t1 - t0;
}
__global__ void lds_chain(double* out, long long* cyc, int n) {
    __shared__ int p[1024];
    for (int i = threadIdx.x; i < 1024; i += blockDim.x) p[i] = (i * 37 + 11) & 1023;
    __syncthreads();
    int j = threadIdx.x;
    long long t0 = clock64();
    for (int i = 0; i < n; ++i) { j = p[j]; j = p[j]; j = p[j]; j = p[j]; }
    long long t1 = clock64();
    out[threadIdx.x] = j; if (threadIdx.x == 0) cyc[0] = t1 - t0;
}
__global__ void shfl_chain(double* out, long long* cyc, double a, int n) {
    double x = a + threadIdx.x;
    long long t0 = clock64();
    for (int i = 0; i < n; ++i) { x = __shfl_sync(0xffffffffu, x, (threadIdx.x + 1) & 31); x = __shfl_sync(0xffffffffu, x, (threadIdx.x + 1) & 31); x = __shfl_sync(0xffffffffu, x, (threadIdx.x + 1) & 31); x = __shfl_sync(0xffffffffu, x, (threadIdx.x + 1) & 31); }
    long long t1 = clock64();
    out[threadIdx.x] = x; if (threadIdx.x == 0) cyc[0] = t1 - t0;
}
__global__ void bar_chain(double* out, long long* cyc, int n) {
    __shared__ double s[256];
    double x = threadIdx.x;
    long long t0 = clock64();
    for (int i = 0; i < n; ++i) {
        s[threadIdx.x] = x; __syncthreads(); x = s[(threadIdx.x + 1) % blockDim.x] * 0.5 + 1.0; __syncthreads();
    }
    long long t1 = clock64();
    out[threadIdx.x] = x; if (threadIdx.x == 0) cyc[0] = t1 - t0;
}
__global__ void syncwarp_chain(double* out, long long* cyc, int n) {
    __shared__ double s[256];
    double x = threadIdx.x;
    long long t0 = clock64();
    for (int i = 0; i < n; ++i) {
        s[threadIdx.x] = x; __syncwarp(); x = s[(threadIdx.x + 1) & 31] * 0.5 + 1.0; __syncwarp();
    }
    long long t1 = clock64();
    out[threadIdx.x] = x; if (threadIdx.x == 0) cyc[0] = t1 - t0;
}
int main() {
    double* out; long long* cyc; long long h;
    cudaMalloc(&out, 1024 * 8); cudaMalloc(&cyc, 8);
    const int n = 1000;
    int clk; cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
    printf("clock rate attr %d kHz\n", clk);
#define RUN(name, launch, ops) launch; cudaDeviceSynchronize(); launch; cudaMemcpy(&h, cyc, 8, cudaMemcpyDeviceToHost); \
    printf("%-28s %8.2f cycles/op  (%s)\n", name, (double)h / (ops), cudaGetErrorString(cudaGetLastError()));
    RUN("dadd dependent", (dadd_chain<<<1, 32>>>(out, cyc, 1.0, 1e-3, n)), 4.0 * n);
    RUN("dmul dependent", (dmul_chain<<<1, 32>>>(out, cyc, 1.0000001, 0.9999999, n)), 4.0 * n);
    RUN("fadd dependent", (fadd_chain<<<1, 32>>>(out, cyc, 1.0, 1e-3, n)), 4.0 * n);
    RUN("dadd 8 indep (per instr)", (dadd_thru<<<1, 32>>>(out, cyc, 1.0, 1e-3, n)), 8.0 * n);
    RUN("lds dependent", (lds_chain<<<1, 32>>>(out, cyc, n)), 4.0 * n);
    RUN("shfl dependent", (shfl_chain<<<1, 32>>>(out, cyc, 1.0, n)), 4.0 * n);
    RUN("sts+bar+lds+bar (1 warp)", (bar_chain<<<1, 32>>>(out, cyc, n)), 1.0 * n);
    RUN("sts+bar+lds+bar (2 warps)", (bar_chain<<<1, 64>>>(out, cyc, n)), 1.0 * n);
    RUN("sts+bar+lds+bar (4 warps)", (bar_chain<<<1, 128>>>(out, cyc, n)), 1.0 * n);
    RUN("sts+syncwarp+lds (1 warp)", (syncwarp_chain<<<1, 32>>>(out, cyc, n)), 1.0 * n);
    return 0;
}
