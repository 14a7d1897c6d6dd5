// Span markers (neuralrecon_w_tpu_torch/tracing.py): one thread writes the
// card's global timer (%globaltimer, ns) into slot 2 * ID + END of the
// span table, END 0 at the span's entry and 1 at its exit.
//
// A marker is launched on the current stream, eagerly or into a CUDA
// graph's capture, so a captured step's spans are stamped on every replay.
// The span's id is a template parameter, so it is in the kernel's name
// (span_mark_kernel<ID, END>): a profiler's device trace says which span
// each marker opens or closes, on the profiler's own clock.

#include <cuda_runtime.h>

#include <utility>

// ids a marker takes: tracing.SPANS's ids lie below it (a CPU test holds
// the two copies together)
constexpr int SPAN_IDS = 16;

template <int ID, int END>
__global__ void span_mark_kernel(unsigned long long* table) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  table[2 * ID + END] = t;
}

using MarkFn = void (*)(unsigned long long*);

template <int... IDS>
static MarkFn mark_fn(int id, int end, std::integer_sequence<int, IDS...>) {
  static const MarkFn begins[] = {&span_mark_kernel<IDS, 0>...};
  static const MarkFn ends[] = {&span_mark_kernel<IDS, 1>...};
  return end ? ends[id] : begins[id];
}

// Returns a cudaError_t value (0 = launched), or -1 for an id outside
// [0, SPAN_IDS), an end other than 0 / 1 or no table.
extern "C" int nw_span_mark(void* table, int id, int end, void* stream) {
  if (table == nullptr || id < 0 || id >= SPAN_IDS || (end != 0 && end != 1)) return -1;
  MarkFn fn = mark_fn(id, end, std::make_integer_sequence<int, SPAN_IDS>{});
  void* args[] = {&table};
  return (int)cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(1), dim3(1), args, 0,
                               static_cast<cudaStream_t>(stream));
}
