// Socket pump of the port's host transport (kungfu_tpu_torch/transport).
//
// The port's copy of native/io_pump.cpp, built into the host library with
// reduce.cpp and mst.cpp (ops/_build.py, compile_host_library). A whole
// framed send (writev of header+payload) or an exact n-byte receive runs
// in ONE ctypes call, which releases the interpreter lock for its whole
// length: the reference drives these byte loops from goroutines
// (srcs/go/rchannel/connection/connection.go:90-146), and a Python loop
// over recv_into would re-take the lock every 64 KiB under contention
// from every other transport thread. The port has no such loop: every
// framed send and exact receive goes through here.
//
// ABI (all return 0 on success, -1 on EOF, -2 on timeout, -errno on error):
//   kf_send2(fd, hdr, hdr_len, payload, payload_len, timeout_ms)
//     writev-loop the [frame header+name | payload] pair until drained.
//   kf_recv_exact(fd, buf, n, timeout_ms)
//     recv-loop exactly n bytes into buf.
//
// Sockets may be blocking or non-blocking (Python socket timeouts put the
// fd in O_NONBLOCK): EAGAIN parks in poll() honouring timeout_ms
// (timeout_ms < 0 means block forever).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <poll.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

namespace {

int64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000 + ts.tv_nsec / 1000000;
}

// Wait for readiness; returns 0 ready, -2 timeout, -errno error.
int wait_fd(int fd, short events, int timeout_ms, int64_t deadline_ms) {
  struct pollfd p;
  p.fd = fd;
  p.events = events;
  for (;;) {
    int t = timeout_ms;
    if (timeout_ms >= 0) {
      int64_t left = deadline_ms - now_ms();
      if (left <= 0) return -2;
      t = (int)left;
    }
    int r = poll(&p, 1, t);
    if (r > 0) return 0;
    if (r == 0) return -2;
    if (errno == EINTR) continue;
    return -errno;
  }
}

}  // namespace

extern "C" {

int kf_send2(int fd, const void *hdr, int64_t hdr_len, const void *payload,
             int64_t payload_len, int timeout_ms) {
  int64_t deadline = timeout_ms >= 0 ? now_ms() + timeout_ms : 0;
  struct iovec iov[2];
  iov[0].iov_base = const_cast<void *>(hdr);
  iov[0].iov_len = (size_t)hdr_len;
  iov[1].iov_base = const_cast<void *>(payload);
  iov[1].iov_len = (size_t)payload_len;
  int iovcnt = payload_len > 0 ? 2 : 1;
  struct iovec *cur = iov;
  while (iovcnt > 0) {
    ssize_t n = writev(fd, cur, iovcnt);
    if (n < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        int w = wait_fd(fd, POLLOUT, timeout_ms, deadline);
        if (w != 0) return w;
        continue;
      }
      return -errno;
    }
    size_t left = (size_t)n;
    while (left > 0 && iovcnt > 0) {
      if (left >= cur->iov_len) {
        left -= cur->iov_len;
        ++cur;
        --iovcnt;
      } else {
        cur->iov_base = (char *)cur->iov_base + left;
        cur->iov_len -= left;
        left = 0;
      }
    }
  }
  return 0;
}

int kf_recv_exact(int fd, void *buf, int64_t n, int timeout_ms) {
  int64_t deadline = timeout_ms >= 0 ? now_ms() + timeout_ms : 0;
  char *p = (char *)buf;
  int64_t got = 0;
  while (got < n) {
    ssize_t r = recv(fd, p + got, (size_t)(n - got), MSG_WAITALL);
    if (r == 0) return -1;  // peer closed
    if (r < 0) {
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        int w = wait_fd(fd, POLLIN, timeout_ms, deadline);
        if (w != 0) return w;
        continue;
      }
      return -errno;
    }
    got += r;
  }
  return 0;
}

}  // extern "C"
