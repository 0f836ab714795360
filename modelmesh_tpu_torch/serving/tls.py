"""The port's own copy of the JAX package's ``serving/tls.py``
(the port imports nothing of that package); names and behaviour
are the reference's.

TLS for the mesh's gRPC surfaces (server-side TLS + optional mutual TLS).

Parity with the reference's TLS support (ModelMeshApi TLS setup; tested by
ModelMeshClusterTlsTest / ClientAuthTest tiers): the external API, internal
forwarding, and runtime links can all run over TLS with the same
certificate configuration; client-auth mode requires peers to present certs
signed by the trusted CA.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import grpc


@dataclasses.dataclass(frozen=True)
class TlsConfig:
    cert_pem: bytes                 # server certificate chain
    key_pem: bytes                  # server private key
    ca_pem: Optional[bytes] = None  # trust roots (peer verification)
    require_client_auth: bool = False
    # Override the authority used for hostname verification on OUTBOUND
    # connections. None (production default) verifies the peer cert against
    # the dialed hostname; tests with a shared self-signed cert set
    # "localhost". Never hardcoded by callers.
    override_authority: Optional[str] = None

    @classmethod
    def from_files(
        cls, cert_path: str, key_path: str, ca_path: Optional[str] = None,
        require_client_auth: bool = False,
    ) -> "TlsConfig":
        with open(cert_path, "rb") as f:
            cert = f.read()
        with open(key_path, "rb") as f:
            key = f.read()
        ca = None
        if ca_path:
            with open(ca_path, "rb") as f:
                ca = f.read()
        return cls(cert, key, ca, require_client_auth)

    def server_credentials(self) -> grpc.ServerCredentials:
        if self.require_client_auth and not self.ca_pem:
            raise ValueError(
                "client-auth (mTLS) requires trust roots: provide ca_pem "
                "(--tls-ca) alongside require_client_auth"
            )
        return grpc.ssl_server_credentials(
            [(self.key_pem, self.cert_pem)],
            root_certificates=self.ca_pem,
            require_client_auth=self.require_client_auth,
        )

    def channel_credentials(self) -> grpc.ChannelCredentials:
        # For mTLS the same cert/key doubles as the client identity
        # (instance-to-instance links use one identity per pod).
        return grpc.ssl_channel_credentials(
            root_certificates=self.ca_pem,
            private_key=self.key_pem if self.require_client_auth else None,
            certificate_chain=self.cert_pem if self.require_client_auth else None,
        )

    # -- raw-socket (non-gRPC) transports ----------------------------------
    # The ZooKeeper jute protocol rides plain TCP, so its TLS wraps the
    # socket directly (a real ensemble's secureClientPort does the same).
    # Both contexts are derived from the SAME PEM material as the gRPC
    # credentials — one coordination-plane identity per pod.

    def _load_identity(self, ctx) -> None:
        import os
        import tempfile

        # ssl.load_cert_chain only takes file paths; stage the in-memory
        # PEMs in private temp files for the duration of the call.
        cf = tempfile.NamedTemporaryFile("wb", suffix=".pem", delete=False)
        kf = tempfile.NamedTemporaryFile("wb", suffix=".pem", delete=False)
        try:
            cf.write(self.cert_pem)
            cf.close()
            kf.write(self.key_pem)
            kf.close()
            ctx.load_cert_chain(cf.name, kf.name)
        finally:
            os.unlink(cf.name)
            os.unlink(kf.name)

    def ssl_server_context(self):
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._load_identity(ctx)
        if self.require_client_auth:
            if not self.ca_pem:
                raise ValueError(
                    "client-auth (mTLS) requires trust roots: provide "
                    "ca_pem alongside require_client_auth"
                )
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(cadata=self.ca_pem.decode())
        return ctx

    def ssl_client_context(self):
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        if self.ca_pem:
            ctx.load_verify_locations(cadata=self.ca_pem.decode())
        else:
            ctx.load_default_certs()
        if self.require_client_auth:
            self._load_identity(ctx)
        return ctx

    def server_hostname(self, dialed_host: str) -> str:
        """The name the client verifies the server cert against —
        override_authority when set (shared test certs), else the dialed
        host (production default)."""
        return self.override_authority or dialed_host


def secure_channel(endpoint: str, tls: Optional[TlsConfig],
                   override_authority: Optional[str] = None) -> grpc.Channel:
    """``override_authority`` defaults to ``tls.override_authority`` so call
    sites don't have to re-plumb a field the config already carries."""
    from modelmesh_tpu_torch.utils.grpcopts import message_size_options

    if tls is None:
        return grpc.insecure_channel(endpoint, options=message_size_options())
    authority = override_authority or tls.override_authority
    options = message_size_options()
    if authority:
        options.append(("grpc.ssl_target_name_override", authority))
    return grpc.secure_channel(endpoint, tls.channel_credentials(), options)


def generate_self_signed(
    common_name: str = "modelmesh-test", days: int = 1
) -> TlsConfig:
    """Test helper: in-memory self-signed cert (CA == leaf)."""
    import datetime

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]
    )
    now = datetime.datetime.now(datetime.timezone.utc)  #: wall-clock: X.509 validity window — peers check it against REAL time; a virtual timestamp would mint an expired cert
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(
            x509.SubjectAlternativeName([
                x509.DNSName(common_name),
                x509.DNSName("localhost"),
            ]),
            critical=False,
        )
        .add_extension(
            x509.BasicConstraints(ca=True, path_length=None), critical=True
        )
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption(),
    )
    return TlsConfig(
        cert_pem=cert_pem, key_pem=key_pem, ca_pem=cert_pem,
        override_authority="localhost",
    )
