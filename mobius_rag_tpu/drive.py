"""External drive/folder ingestion (reference: app/services/drive_sync.py
+ drive_classifier.py + main.py:6161-7060 — Google Drive OAuth, folder
scan, per-file classification, bulk import).

The transport is a protocol: `HTTPDrive` is the production client — a
Drive-v3-shaped REST transport with the OAuth2 refresh-token exchange
done over plain urllib (no SDK, drive_sync.py parity) — and tests/
air-gapped pods use the in-memory one (this image has no egress, so
HTTPDrive is exercised against a local stub server). Classification
reuses the curator's payer/authority inference plus filename heuristics
(drive_classifier.py's fallback-regex role)."""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time
import urllib.parse
import urllib.request
from typing import Any, Protocol

from mobius_rag_tpu.curator import classify_url
from mobius_rag_tpu.ingest.metadata import canonical_payer, canonical_state


class DriveClient(Protocol):
    def list_folder(self, folder_id: str) -> list[dict[str, Any]]:
        """→ [{"file_id", "name", "mime", "size"}]"""
        ...

    def download(self, file_id: str) -> bytes: ...


class InMemoryDrive:
    """Test/air-gapped drive: a dict of folders → files."""

    def __init__(self, folders: dict[str, list[tuple[str, bytes]]]):
        self._folders = folders

    def list_folder(self, folder_id: str) -> list[dict[str, Any]]:
        return [
            {"file_id": f"{folder_id}/{name}", "name": name,
             "mime": "text/plain", "size": len(data)}
            for name, data in self._folders.get(folder_id, [])
        ]

    def download(self, file_id: str) -> bytes:
        folder, name = file_id.rsplit("/", 1)
        for n, data in self._folders.get(folder, []):
            if n == name:
                return data
        raise FileNotFoundError(file_id)


class HTTPDrive:
    """Drive-v3-shaped REST client (drive_sync.py's transport role).

    Auth: a static bearer (MRAG_DRIVE_ACCESS_TOKEN) or the OAuth2
    refresh-token grant — POST client_id/client_secret/refresh_token to
    the token endpoint, cache the access token until 60s before expiry.
    Google-native documents (mime application/vnd.google-apps.*) can't
    be fetched with alt=media; they go through /export as text/plain.

    Endpoints are overridable (MRAG_DRIVE_API / MRAG_DRIVE_TOKEN_URL) so
    the client runs against SharePoint-style gateways or a test stub.
    """

    def __init__(self, *, api_base: str | None = None,
                 token_url: str | None = None,
                 client_id: str | None = None,
                 client_secret: str | None = None,
                 refresh_token: str | None = None,
                 access_token: str | None = None,
                 timeout_s: float = 30.0):
        env = os.environ.get
        self.api_base = (api_base or env("MRAG_DRIVE_API",
                         "https://www.googleapis.com/drive/v3")).rstrip("/")
        self.token_url = token_url or env(
            "MRAG_DRIVE_TOKEN_URL", "https://oauth2.googleapis.com/token")
        self.client_id = client_id or env("MRAG_DRIVE_CLIENT_ID", "")
        self.client_secret = client_secret or env("MRAG_DRIVE_CLIENT_SECRET", "")
        self.refresh_token = refresh_token or env("MRAG_DRIVE_REFRESH_TOKEN", "")
        self._access_token = access_token or env("MRAG_DRIVE_ACCESS_TOKEN", "")
        self._token_expiry = float("inf") if self._access_token else 0.0
        self.timeout_s = timeout_s

    def _token(self) -> str:
        if self._access_token and time.time() < self._token_expiry - 60:
            return self._access_token
        if not self.refresh_token:
            raise RuntimeError(
                "HTTPDrive has no access token and no refresh credentials "
                "(set MRAG_DRIVE_ACCESS_TOKEN or MRAG_DRIVE_CLIENT_ID/"
                "CLIENT_SECRET/REFRESH_TOKEN)")
        body = urllib.parse.urlencode({
            "client_id": self.client_id,
            "client_secret": self.client_secret,
            "refresh_token": self.refresh_token,
            "grant_type": "refresh_token",
        }).encode()
        req = urllib.request.Request(self.token_url, data=body, method="POST")
        req.add_header("Content-Type", "application/x-www-form-urlencoded")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            tok = json.loads(r.read().decode())
        self._access_token = tok["access_token"]
        self._token_expiry = time.time() + float(tok.get("expires_in", 3600))
        return self._access_token

    def _get(self, path: str, params: dict[str, str]) -> bytes:
        url = f"{self.api_base}{path}?{urllib.parse.urlencode(params)}"
        req = urllib.request.Request(url)
        req.add_header("Authorization", f"Bearer {self._token()}")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
            return r.read()

    def list_folder(self, folder_id: str) -> list[dict[str, Any]]:
        files: list[dict[str, Any]] = []
        page_token = ""
        while True:
            params = {
                "q": f"'{folder_id}' in parents and trashed = false",
                "fields": "nextPageToken,files(id,name,mimeType,size)",
                "pageSize": "1000",
            }
            if page_token:
                params["pageToken"] = page_token
            page = json.loads(self._get("/files", params).decode())
            files.extend(
                {"file_id": f["id"], "name": f.get("name", ""),
                 "mime": f.get("mimeType", ""),
                 "size": int(f.get("size", 0) or 0)}
                for f in page.get("files", [])
            )
            page_token = page.get("nextPageToken", "")
            if not page_token:
                return files

    def download(self, file_id: str, *, mime: str = "") -> bytes:
        if mime.startswith("application/vnd.google-apps"):
            return self._get(f"/files/{file_id}/export",
                             {"mimeType": "text/plain"})
        return self._get(f"/files/{file_id}", {"alt": "media"})


def oauth_device_flow(*, client_id: str | None = None,
                      client_secret: str | None = None,
                      scope: str = "https://www.googleapis.com/auth/drive.readonly",
                      device_url: str | None = None,
                      token_url: str | None = None,
                      prompt: Any = print,
                      sleep: Any = time.sleep,
                      timeout_s: float = 30.0,
                      max_wait_s: float = 600.0) -> dict[str, str]:
    """OAuth2 *device flow* bootstrap (RFC 8628) — how a headless server
    obtains the refresh token HTTPDrive's refresh-grant transport uses
    (reference drive_sync.py runs the equivalent interactive consent in
    the browser session of main.py:6365's /drive/auth flow).

    POSTs the device-code request, surfaces ``user_code`` +
    ``verification_url`` through ``prompt``, then polls the token
    endpoint honoring ``interval``/``slow_down`` until the operator
    approves. Returns the token payload (``refresh_token``,
    ``access_token``); callers persist the refresh token into
    MRAG_DRIVE_REFRESH_TOKEN. Endpoints overridable for gateway/test
    stubs (MRAG_DRIVE_DEVICE_URL / MRAG_DRIVE_TOKEN_URL)."""
    env = os.environ.get
    client_id = client_id or env("MRAG_DRIVE_CLIENT_ID", "")
    client_secret = client_secret or env("MRAG_DRIVE_CLIENT_SECRET", "")
    if not client_id:
        raise RuntimeError("device flow requires MRAG_DRIVE_CLIENT_ID")
    device_url = device_url or env("MRAG_DRIVE_DEVICE_URL",
                                   "https://oauth2.googleapis.com/device/code")
    token_url = token_url or env("MRAG_DRIVE_TOKEN_URL",
                                 "https://oauth2.googleapis.com/token")

    def post(url: str, fields: dict[str, str]) -> dict[str, Any]:
        req = urllib.request.Request(
            url, data=urllib.parse.urlencode(fields).encode(), method="POST",
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return json.loads(r.read().decode())
        except urllib.error.HTTPError as e:
            # OAuth polling errors ride 4xx bodies (authorization_pending
            # / slow_down are not failures)
            return json.loads(e.read().decode())

    dev = post(device_url, {"client_id": client_id, "scope": scope})
    if "device_code" not in dev:
        raise RuntimeError(f"device-code request failed: {dev}")
    prompt(f"Visit {dev.get('verification_url', dev.get('verification_uri'))}"
           f" and enter code: {dev['user_code']}")
    interval = float(dev.get("interval", 5))
    waited = 0.0
    while waited < min(max_wait_s, float(dev.get("expires_in", max_wait_s))):
        sleep(interval)
        waited += interval
        tok = post(token_url, {
            "client_id": client_id, "client_secret": client_secret,
            "device_code": dev["device_code"],
            "grant_type": "urn:ietf:params:oauth:grant-type:device_code",
        })
        err = tok.get("error", "")
        if not err:
            return tok
        if err == "slow_down":
            interval += 5
        elif err != "authorization_pending":
            raise RuntimeError(f"device flow failed: {err}")
    raise TimeoutError("device flow not approved in time")


_PAYERISH = re.compile(
    r"(sunshine|aetna|molina|ahca|medicaid|medicare)", re.IGNORECASE)
# letter-boundaries rather than \b: filenames use underscores, which are
# word characters ("FL_Sunshine" must still match FL)
_STATEISH = re.compile(r"(?<![A-Za-z])(FL|GA|TX|florida|georgia|texas)(?![A-Za-z])",
                       re.IGNORECASE)


def classify_file(name: str) -> dict[str, Any]:
    """Filename → payer/state guess (drive_classifier.py fallback-regex
    parity; a payor-registry service hook can override upstream)."""
    payer_m = _PAYERISH.search(name)
    state_m = _STATEISH.search(name)
    url_cls = classify_url(f"https://drive.local/{name}")
    return {
        "payer": canonical_payer(payer_m.group(1)) if payer_m else "",
        "state": canonical_state(state_m.group(1)) if state_m else "",
        "looks_like_manual": url_cls["looks_like_manual"],
    }


@dataclasses.dataclass
class DriveImportResult:
    scanned: int
    imported: list[str]
    skipped: list[dict[str, Any]]


def import_folder(pipeline, client: DriveClient, folder_id: str, *,
                  manuals_only: bool = True,
                  max_bytes: int = 50 * 1024 * 1024) -> DriveImportResult:
    """Scan a folder, classify each file, upload the keepers through the
    normal ingest path (sha-dedupe + instant-path rules apply)."""
    files = client.list_folder(folder_id)
    imported, skipped = [], []
    for f in files:
        cls = classify_file(f["name"])
        if manuals_only and not cls["looks_like_manual"]:
            skipped.append({"name": f["name"], "reason": "not manual-like"})
            continue
        if f.get("size", 0) > max_bytes:
            skipped.append({"name": f["name"], "reason": "too large"})
            continue
        data = client.download(f["file_id"])
        res = pipeline.upload(data, f["name"], payer=cls["payer"],
                              state=cls["state"])
        if res.deduped:
            skipped.append({"name": f["name"], "reason": "duplicate"})
        else:
            imported.append(res.doc_id)
    return DriveImportResult(len(files), imported, skipped)
