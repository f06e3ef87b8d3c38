// The record and replay of the selective remat policies (core/remat.py):
// the outputs of the convolutions and matrix products of an inner step are
// kept in its forward and handed back, in the same order, when the outer
// backward recomputes the step.
//
// Host C++, not a TPU kernel: it replaces the Python dispatch mode that
// did this before, whose calls (about 7 per dot call site: the dot and the
// views of vmap's batching rule) cost more host time than the recompute
// of the dots saved. Here a boxed kernel sits on the ADInplaceOrView key of
// aten.convolution, aten.mm, aten.addmm and aten.bmm only. That key is
// below Autograd, so autograd above still records each op with its inputs,
// and below functorch's batching rule, so the kernel sees the plain op the
// rule calls. Every other op never reaches this file. At the grad
// transform's level the same key sees the op on functorch's wrappers: those
// calls pass through. A dot is kept or replaced only while the thread runs
// a record or a replay (record(), replay(), finish(); one at a time) and a
// dot call site is armed (remat_dots_site, from models/layers.py through
// core/remat.py::dot).
//
// Built at first use by torch.utils.cpp_extension (g++, ninja) into the
// package's build/ directory and loaded with torch.ops.load_library.

#include <ATen/core/dispatch/Dispatcher.h>
#include <ATen/core/stack.h>
#include <torch/library.h>

#include <cstdint>
#include <sstream>
#include <string>
#include <tuple>
#include <vector>

namespace {

enum Kind : int64_t { kConvolution = 0, kMm = 1, kAddmm = 2, kBmm = 3 };

// the names core/remat.py's messages give the ops
const char* const kNames[] = {"aten.convolution.default", "aten.mm.default", "aten.addmm.default",
                              "aten.bmm.default"};

enum class Mode { kOff, kRecord, kReplay };

struct Tape {
  Mode mode = Mode::kOff;
  bool armed = false;  // inside a dot call site
  std::vector<at::Tensor> outs;
  std::vector<int64_t> kinds;
  size_t next = 0;  // the replay's next entry
};

thread_local Tape tape;

const c10::DispatchKeySet kBelow(c10::DispatchKeySet::FULL_AFTER, c10::DispatchKey::ADInplaceOrView);
const c10::DispatchKeySet kFunctorch({c10::DispatchKey::FuncTorchGradWrapper, c10::DispatchKey::FuncTorchBatched});

// no argument is a functorch wrapper: the op as the batching rule calls it
bool plain(const torch::jit::Stack& stack, size_t n) {
  for (size_t i = stack.size() - n; i < stack.size(); ++i) {
    if (stack[i].isTensor() && stack[i].toTensor().key_set().has_any(kFunctorch)) return false;
  }
  return true;
}

std::vector<int64_t> ints(const c10::IValue& v) {
  std::vector<int64_t> out;
  for (const auto& x : v.toListRef()) out.push_back(x.isInt() ? x.toInt() : x.toSymInt().expect_int());
  return out;
}

// aten.convolution's output shape (not transposed), from its arguments at
// stack[base..]: input, weight, bias, stride, padding, dilation, ...
std::vector<int64_t> conv_shape(const torch::jit::Stack& stack, size_t base) {
  const auto x = stack[base].toTensor().sizes();
  const auto w = stack[base + 1].toTensor().sizes();
  const auto stride = ints(stack[base + 3]), padding = ints(stack[base + 4]), dilation = ints(stack[base + 5]);
  std::vector<int64_t> out = {x[0], w[0]};
  for (size_t d = 0; d + 2 < x.size(); ++d) {
    out.push_back((x[d + 2] + 2 * padding[d] - dilation[d] * (w[d + 2] - 1) - 1) / stride[d] + 1);
  }
  return out;
}

std::string tuple_str(c10::ArrayRef<int64_t> shape) {
  std::ostringstream s;
  s << "(";
  for (size_t i = 0; i < shape.size(); ++i) s << (i ? ", " : "") << shape[i];
  s << (shape.size() == 1 ? ",)" : ")");
  return s.str();
}

template <int64_t K>
void dot(const c10::OperatorHandle& op, c10::DispatchKeySet ks, torch::jit::Stack* stack) {
  Tape& t = tape;
  const size_t n = op.schema().arguments().size();
  if (!t.armed || t.mode == Mode::kOff || !plain(*stack, n)) {
    op.redispatchBoxed(ks & kBelow, stack);
    return;
  }
  if (t.mode == Mode::kRecord) {
    op.redispatchBoxed(ks & kBelow, stack);
    t.outs.push_back(stack->back().toTensor());
    t.kinds.push_back(K);
    return;
  }
  TORCH_CHECK(t.next < t.outs.size(), "remat: the recompute met more dot ops than the forward (", kNames[K], ")");
  TORCH_CHECK(t.kinds[t.next] == K, "remat: the recompute met ", kNames[K], " where the forward met ",
              kNames[t.kinds[t.next]]);
  const at::Tensor& out = t.outs[t.next];
  if (K == kConvolution && !(*stack)[stack->size() - n + 6].toBool()) {
    const auto want = conv_shape(*stack, stack->size() - n);
    TORCH_CHECK(out.sizes().vec() == want, "remat: a recorded convolution has shape ", tuple_str(out.sizes()),
                ", the recompute's ", tuple_str(want));
  }
  torch::jit::drop(*stack, n);
  stack->emplace_back(out);
  ++t.next;
}

void start(Mode mode) {
  TORCH_CHECK(tape.mode == Mode::kOff, "remat: a record or replay already runs on this thread");
  tape = Tape();
  tape.mode = mode;
}

void record() { start(Mode::kRecord); }

void replay(std::vector<at::Tensor> outs, std::vector<int64_t> kinds) {
  TORCH_CHECK(outs.size() == kinds.size(), "remat: a tape of ", outs.size(), " outputs and ", kinds.size(), " ops");
  start(Mode::kReplay);
  tape.outs = std::move(outs);
  tape.kinds = std::move(kinds);
}

// ends the thread's record or replay: the recorded outputs and their ops
// (empty after a replay) and how many entries the replay handed back
std::tuple<std::vector<at::Tensor>, std::vector<int64_t>, int64_t> finish() {
  Tape done = std::move(tape);
  tape = Tape();
  if (done.mode == Mode::kReplay) return {{}, {}, static_cast<int64_t>(done.next)};
  const auto recorded = static_cast<int64_t>(done.kinds.size());
  return {std::move(done.outs), std::move(done.kinds), recorded};
}

}  // namespace

// arms (on != 0) or disarms this thread's dot call site; called through
// ctypes, around each site, so that it costs no dispatch
extern "C" void remat_dots_site(int on) { tape.armed = on != 0; }

TORCH_LIBRARY(remat_dots, m) {
  m.def("record() -> ()", &record);
  m.def("replay(Tensor[] outs, int[] kinds) -> ()", &replay);
  m.def("finish() -> (Tensor[], int[], int)", &finish);
}

TORCH_LIBRARY_IMPL(aten, ADInplaceOrView, m) {
  m.impl("convolution", torch::CppFunction::makeFromBoxedFunction<&dot<kConvolution>>());
  m.impl("mm", torch::CppFunction::makeFromBoxedFunction<&dot<kMm>>());
  m.impl("addmm", torch::CppFunction::makeFromBoxedFunction<&dot<kAddmm>>());
  m.impl("bmm", torch::CppFunction::makeFromBoxedFunction<&dot<kBmm>>());
}
