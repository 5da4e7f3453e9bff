// Native TCP transport primitives for the party mesh (the port's copy of
// sfgwas_tpu/native/transport.cpp, with the same C interface and wire).
//
// Blocking socket IO runs here, called through ctypes, so sends and
// receives run without the interpreter lock and large ciphertext and share
// buffers move with few syscalls.  A frame is an 8-byte little-endian
// length followed by the payload.
//
// API (C linkage, bound by parallel/native_transport.py):
//   int  sfg_listen(int port, const char* bind_ip)        -> listen fd
//   int  sfg_accept(int listen_fd)                        -> conn fd
//   int  sfg_accept_within(int listen_fd, int timeout_ms) -> conn fd, or -1
//                                        when no peer dialled in time
//   int  sfg_connect(const char* host, int port, int retries, int delay_ms)
//   int  sfg_send_frame(int fd, const uint8_t* buf, int64_t len)
//   int64_t sfg_recv_frame_len(int fd)                    -> next frame size
//   int  sfg_recv_frame_body(int fd, uint8_t* buf, int64_t len)
//   void sfg_close(int fd)   (shuts the socket down first, so a receive
//                             blocked on it in another thread returns)

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

bool send_all(int fd, const uint8_t* buf, int64_t len) {
  while (len > 0) {
    ssize_t n = ::send(fd, buf, static_cast<size_t>(len), MSG_NOSIGNAL);
    if (n <= 0) {
      if (n < 0 && (errno == EINTR)) continue;
      return false;
    }
    buf += n;
    len -= n;
  }
  return true;
}

bool recv_all(int fd, uint8_t* buf, int64_t len) {
  while (len > 0) {
    ssize_t n = ::recv(fd, buf, static_cast<size_t>(len), 0);
    if (n <= 0) {
      if (n < 0 && (errno == EINTR)) continue;
      return false;
    }
    buf += n;
    len -= n;
  }
  return true;
}

}  // namespace

extern "C" {

int sfg_listen(int port, const char* bind_ip) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr =
      (bind_ip && bind_ip[0]) ? inet_addr(bind_ip) : INADDR_ANY;
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 4) != 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

int sfg_accept(int listen_fd) {
  int fd = ::accept(listen_fd, nullptr, nullptr);
  if (fd >= 0) {
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }
  return fd;
}

int sfg_accept_within(int listen_fd, int timeout_ms) {
  pollfd p{};
  p.fd = listen_fd;
  p.events = POLLIN;
  int r;
  do {
    r = ::poll(&p, 1, timeout_ms);
  } while (r < 0 && errno == EINTR);
  if (r <= 0) return -1;
  return sfg_accept(listen_fd);
}

int sfg_connect(const char* host, int port, int retries, int delay_ms) {
  for (int attempt = 0; attempt < retries; ++attempt) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    addr.sin_addr.s_addr = inet_addr(host);
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      return fd;
    }
    ::close(fd);
    ::usleep(static_cast<useconds_t>(delay_ms) * 1000);
  }
  return -1;
}

int sfg_send_frame(int fd, const uint8_t* buf, int64_t len) {
  uint8_t hdr[8];
  std::memcpy(hdr, &len, 8);  // little-endian hosts
  if (!send_all(fd, hdr, 8)) return -1;
  return send_all(fd, buf, len) ? 0 : -1;
}

int64_t sfg_recv_frame_len(int fd) {
  uint8_t hdr[8];
  if (!recv_all(fd, hdr, 8)) return -1;
  int64_t len;
  std::memcpy(&len, hdr, 8);
  return len;
}

int sfg_recv_frame_body(int fd, uint8_t* buf, int64_t len) {
  return recv_all(fd, buf, len) ? 0 : -1;
}

void sfg_close(int fd) {
  ::shutdown(fd, SHUT_RDWR);
  ::close(fd);
}

}  // extern "C"
