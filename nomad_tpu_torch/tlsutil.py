"""mTLS for the RPC tier (ref helper/tlsutil/: CA-pinned mutual TLS
wrapping the server RPC listener and every outbound connection).

Both directions require certificates signed by the cluster CA
(CERT_REQUIRED): a peer without a CA-signed cert can neither serve nor
call. Hostname checking is disabled in favor of CA pinning — the
reference likewise verifies region-role names against its own CA rather
than public-PKI hostnames. ``generate_dev_certs`` shells out to openssl
to mint a throwaway CA + node certificate for dev clusters and tests;
production brings its own PKI."""

from __future__ import annotations

import os
import ssl
import subprocess


class TLSError(RuntimeError):
    pass


def server_context(ca: str, cert: str, key: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cert, key)
    ctx.load_verify_locations(ca)
    ctx.verify_mode = ssl.CERT_REQUIRED  # mutual: clients must present
    return ctx


def client_context(ca: str, cert: str, key: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cert, key)
    ctx.load_verify_locations(ca)
    ctx.check_hostname = False  # CA-pinned, not public-PKI hostnames
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def contexts_from_config(tls_config: dict):
    """(server_ctx, client_ctx) from a {ca, cert, key} config block, or
    (None, None) when TLS is not configured."""
    if not tls_config:
        return None, None
    ca = tls_config.get("ca")
    cert = tls_config.get("cert")
    key = tls_config.get("key")
    if not (ca and cert and key):
        raise TLSError("tls config requires ca, cert, and key paths")
    return server_context(ca, cert, key), client_context(ca, cert, key)


def generate_dev_certs(directory: str, name: str = "node") -> dict:
    """Mint a throwaway CA + a CA-signed cert for 127.0.0.1 via openssl;
    returns the {ca, cert, key} config block."""
    os.makedirs(directory, exist_ok=True)
    ca_key = os.path.join(directory, "ca.key")
    ca_crt = os.path.join(directory, "ca.crt")
    key = os.path.join(directory, f"{name}.key")
    csr = os.path.join(directory, f"{name}.csr")
    crt = os.path.join(directory, f"{name}.crt")
    ext = os.path.join(directory, f"{name}.ext")

    def run(*args):
        proc = subprocess.run(args, capture_output=True, text=True)
        if proc.returncode != 0:
            raise TLSError(f"openssl failed: {proc.stderr}")

    if not os.path.exists(ca_crt):
        run(
            "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", ca_key, "-out", ca_crt, "-days", "30",
            "-subj", "/CN=nomad-tpu-dev-ca",
        )
    run(
        "openssl", "req", "-newkey", "rsa:2048", "-nodes",
        "-keyout", key, "-out", csr, "-subj", f"/CN={name}",
    )
    with open(ext, "w") as f:
        f.write("subjectAltName=IP:127.0.0.1,DNS:localhost\n")
    run(
        "openssl", "x509", "-req", "-in", csr, "-CA", ca_crt,
        "-CAkey", ca_key, "-CAcreateserial", "-out", crt,
        "-days", "30", "-extfile", ext,
    )
    return {"ca": ca_crt, "cert": crt, "key": key}
